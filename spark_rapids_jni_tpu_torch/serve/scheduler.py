"""The overload-tolerant query scheduler (the port of the JAX package's
``serve/scheduler.py``).

One ``Scheduler`` owns N dispatch-slot threads
(``SRJTORCH_SERVE_MAX_CONCURRENT``). ``submit()`` enqueues a query into
its tenant's bounded FIFO queue; slots pull queries via STRIDE
scheduling (weighted-fair: each tenant carries a ``pass`` value
advanced by ``stride = K / weight`` per dispatch, and the non-empty
tenant with the minimum pass runs next — a saturating tenant advances
its pass N× faster than a trickling one, so the trickle keeps its
share). Admission is where ALL load shedding happens:

    submit() ──▶ QUEUED ──(weighted-fair dispatch)──▶ RUNNING ──▶ done
       │shed          │cancel()/expire                │cancel() ─▶ token
       ▼              ▼                               ▼
    Overloaded     cancelled/expired             cancelled/failed
    (retryable,    (DeadlineExceeded)            (DeadlineExceeded)
     retry_after_s)

Shed decisions (every one a retryable ``Overloaded`` raised to the
SUBMITTER, or completed into an evicted victim's handle — never a
mid-flight kill, never a timeout in disguise):

- **queue_full**: the tenant's queue is at ``SRJTORCH_SERVE_QUEUE_DEPTH``.
  Lowest-priority-first: an incoming query of strictly higher priority
  evicts the queue's lowest-priority entry instead of being refused.
- **pressure**: the overload controller trips — global queued count at
  ``SRJTORCH_SERVE_MAX_QUEUED``, the oldest queued query older than
  ``SRJTORCH_SERVE_MAX_QUEUE_AGE_SEC``, or the memory governor reporting
  blocked admissions — and the incoming query does not outrank the
  lowest-priority queued one.
- **doa_deadline**: the submission's effective budget is already gone
  at admission (fast-fail beats queuing work that must expire).
- **breaker**: the sidecar pool is dark (circuit breaker OPEN) and the
  query declared ``host_eligible=False`` — host-engine-eligible work
  keeps flowing when the pool is down.
- **quarantine**: every LIVE pool worker is quarantined by
  the gray-failure detector (sidecar_pool.py) and the query declared
  ``host_eligible=False`` — device-only work is shed instead of
  queueing onto known stragglers; host-eligible work keeps flowing.
- **cluster_degraded**: an attached
  ``parallel.cluster.ClusterView`` is below quorum — too many exchange
  ranks DEAD for a distributed query to complete; refused at admission
  (retryable: quorum returns when replacement ranks join) instead of
  queued into a fabric that would burn retry budgets mid-exchange.
- **shutting_down**: ``shutdown()`` was called.
- **injected**: the fault injector's ``reject`` kind fired at the
  ``serve.admit`` choke point (deterministic shed-path chaos).

Deadlines span the QUEUE: a query's budget starts at submit, so one
that expires while queued never dispatches (``serve.expired_in_queue``)
and a dispatched one runs under ``deadline.scope`` with whatever
budget the wait left — cancel() trips the handle's CancelToken, which
the deadline machinery propagates through retry backoffs, shuffle
escalations, and sidecar socket deadlines.

Observability: durable counters are registry-direct
(``serve.submitted/completed/failed/cancelled``, ``serve.shed_total``
+ ``serve.shed.<cause>``, ``serve.expired_in_queue``, queue/running
gauges); queue-wait/run/e2e histograms and ``serve.*`` events ride the
``SRJTORCH_METRICS_ENABLED`` gate like every other hot path.
"""

from __future__ import annotations

import itertools
import math
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from ..utils import deadline as deadline_mod
from ..utils import faultinj, knobs, metrics, tracing
from ..utils.deadline import CancelToken
from ..utils.errors import DeadlineExceeded, Overloaded

__all__ = [
    "Scheduler",
    "QueryHandle",
    "SHED_CAUSES",
    "scheduler",
    "submit",
    "shutdown_scheduler",
    "stats_section",
    "live_scheduler_count",
    "leak_report",
]

# handle states
S_QUEUED = "queued"
S_RUNNING = "running"
S_DONE = "done"
S_FAILED = "failed"
S_CANCELLED = "cancelled"
S_SHED = "shed"
S_EXPIRED = "expired"

_FINAL = (S_DONE, S_FAILED, S_CANCELLED, S_SHED, S_EXPIRED)

# handle state -> trace root status (the flight recorder flushes
# every non-"ok" trace, so shed/failed/expired/cancelled queries from a
# storm are all captured with their span trees)
_TRACE_STATUS = {
    S_DONE: "ok",
    S_FAILED: "failed",
    S_CANCELLED: "cancelled",
    S_SHED: "shed",
    S_EXPIRED: "expired",
}


def _shed_trace(qt, cause: str) -> None:
    """Finish a (possibly None) root trace as shed — the recorder's
    capture of an admission-rejected query."""
    if qt is not None:
        qt.annotate(shed_cause=cause)
        qt.finish("shed")

SHED_CAUSES = ("queue_full", "pressure", "doa_deadline", "breaker",
               "quarantine", "cluster_degraded", "shutting_down",
               "injected", "forecast")

# stride scheduling: pass advance per dispatch for weight 1.0
_STRIDE1 = float(1 << 20)

# lane-map size at which creating a NEW tenant first prunes idle lanes
_LANE_PRUNE_AT = 64


class QueryHandle:
    """The submitter's view of one query: ``result()`` / ``cancel()`` /
    ``status()``. Created only by ``Scheduler.submit``."""

    __slots__ = (
        "_scheduler", "_fn", "_args", "_kwargs", "tenant", "priority",
        "query_id", "_memory_bytes", "host_eligible", "_token", "_done",
        "_state", "_result", "_exc", "_t_submit", "_t_deadline",
        "_t_dispatch", "_budget_s", "_trace", "_predicted_cost_s",
        "_jid",
    )

    def __init__(self, scheduler, fn, args, kwargs, tenant, priority,
                 budget_s, memory_bytes, host_eligible, query_id,
                 t_submit):
        self._scheduler = scheduler
        self._fn = fn
        self._args = args
        self._kwargs = kwargs
        self.tenant = tenant
        self.priority = int(priority)
        self.query_id = query_id
        self._memory_bytes = memory_bytes
        self.host_eligible = bool(host_eligible)
        self._token = CancelToken()
        self._done = threading.Event()
        self._state = S_QUEUED
        self._result: Any = None
        self._exc: Optional[BaseException] = None
        self._t_submit = t_submit
        self._budget_s = budget_s
        self._t_deadline = None if budget_s is None else t_submit + budget_s
        self._t_dispatch: Optional[float] = None
        self._trace = None  # trace root (tracing.QueryTrace), or None
        # observed-cost EWMA of the cached plan structure,
        # None for uncached/never-run plans — the forecast controller's
        # per-query input
        self._predicted_cost_s: Optional[float] = None
        # durable-journal id: set under the
        # admission lock when the journal is armed, None otherwise —
        # the one-attribute-read gate every state-transition write pays
        self._jid: Optional[str] = None

    # -- the public surface --------------------------------------------------

    def status(self) -> str:
        """One of queued/running/done/failed/cancelled/shed/expired."""
        return self._state

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout_s: Optional[float] = None):
        """Block for the outcome: the fn's return value, or re-raise
        its failure (``Overloaded`` for a shed, ``DeadlineExceeded``
        for expiry/cancellation, the fn's own exception otherwise).
        ``timeout_s`` bounds the WAIT, not the query — on timeout the
        query keeps running and a ``TimeoutError`` is raised here."""
        if not self._done.wait(timeout_s):
            raise TimeoutError(
                f"query {self.query_id} not done after {timeout_s}s "
                f"(state={self._state})"
            )
        if self._exc is not None:
            raise self._exc
        return self._result

    def cancel(self, reason: str = "cancelled") -> bool:
        """Cancel cooperatively: a QUEUED query completes immediately
        (``DeadlineExceeded``, never dispatched); a RUNNING one has its
        CancelToken tripped — the deadline machinery unwinds it at the next
        cancel point (op boundary, retry backoff, sidecar socket
        deadline) with no sidecar desync, because the token rides the
        SAME deadline scope every layer already consults. False when
        the query already reached a final state."""
        return self._scheduler._cancel(self, reason)

    def exception(self) -> Optional[BaseException]:
        """The stored failure after completion (None while pending or
        on success) — for callers polling instead of result()."""
        return self._exc

    def __repr__(self):
        return (f"QueryHandle(id={self.query_id}, tenant={self.tenant!r}, "
                f"priority={self.priority}, state={self._state})")


class _Tenant:
    """Per-tenant QoS state: the bounded FIFO queue + stride lane.
    INVARIANT: the deque holds only S_QUEUED handles — every finish
    path (cancel/evict/shutdown) removes under the scheduler lock and
    the dispatcher pops — so ``len(q)`` IS the queue depth and ``q[0]``
    the tenant's oldest queued query."""

    __slots__ = ("name", "q", "weight", "stride", "pass_", "submitted",
                 "completed", "failed", "shed", "expired", "cancelled")

    def __init__(self, name: str, weight: float):
        self.name = name
        self.q: deque = deque()
        self.weight = 1.0
        self.stride = _STRIDE1
        self.set_weight(weight)
        self.pass_ = 0.0
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        self.shed = 0
        self.expired = 0
        self.cancelled = 0

    def set_weight(self, weight: float) -> None:
        w = float(weight)
        if w <= 0:
            raise ValueError(f"tenant weight must be > 0, got {weight}")
        self.weight = w
        self.stride = _STRIDE1 / w


class Scheduler:
    """The concurrent serving runtime: see the module docstring for
    the state machine and shed taxonomy. One instance owns its worker
    threads; ``shutdown()`` joins them all (the leak assertion in
    the test suite holds every session to that)."""

    def __init__(
        self,
        max_concurrent: Optional[int] = None,
        queue_depth: Optional[int] = None,
        max_queued: Optional[int] = None,
        max_queue_age_s: Optional[float] = None,
        retry_after_s: Optional[float] = None,
        name: str = "serve",
        clock=time.monotonic,
    ):
        self.name = str(name)
        self._clock = clock
        self._slots = int(
            knobs.get_int("SRJTORCH_SERVE_MAX_CONCURRENT")
            if max_concurrent is None else max_concurrent
        )
        if self._slots < 1:
            raise ValueError(f"max_concurrent must be >= 1, got {self._slots}")
        self._queue_depth = int(
            knobs.get_int("SRJTORCH_SERVE_QUEUE_DEPTH")
            if queue_depth is None else queue_depth
        )
        if self._queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, got {self._queue_depth}")
        self._max_queued = int(
            knobs.get_int("SRJTORCH_SERVE_MAX_QUEUED")
            if max_queued is None else max_queued
        )
        self._max_queue_age_s = float(
            knobs.get_float("SRJTORCH_SERVE_MAX_QUEUE_AGE_SEC")
            if max_queue_age_s is None else max_queue_age_s
        )
        self._retry_after_s = float(
            knobs.get_float("SRJTORCH_SERVE_RETRY_AFTER_SEC")
            if retry_after_s is None else retry_after_s
        )
        self._cond = threading.Condition(threading.Lock())
        # srjt-race layer 2: the tenant-lane table is tracked — every
        # key/iteration access is checked for happens-before ordering
        # when SRJTORCH_RACE=1 (a plain dict otherwise, zero cost)
        from ..analysis.lockdep import track as _race_track

        self._tenants: Dict[str, _Tenant] = _race_track(
            {}, f"serve.{self.name}.tenants"
        )
        self._queued = 0  # entries in S_QUEUED across all tenant deques
        self._running = 0
        self._cluster = None  # ClusterView: quorum-loss shed
        self._inflight: set = set()
        self._pass_floor = 0.0
        self._open = True
        self._ids = itertools.count(1)
        self._reg().gauge("serve.slots").set(self._slots)
        self._workers = [
            threading.Thread(
                target=self._worker_loop,
                name=f"srjtorch-serve-{self.name}-{i}",
                daemon=True,
            )
            for i in range(self._slots)
        ]
        with _live_lock:
            _LIVE.add(self)
            global _ever_created
            _ever_created = True
        for w in self._workers:
            w.start()

    # -- plumbing ------------------------------------------------------------

    @staticmethod
    def _reg():
        return metrics.registry()

    def _count_shed(self, cause: str) -> None:
        """Durable shed accounting (registry-direct, the breaker
        contract): chaos gates assert serve.shed_total > 0 from these.
        Counters only — safe under the dispatch lock; the matching
        ``serve.shed`` EVENT (file I/O) is emitted by ``_shed_event``
        strictly outside it. Per-tenant ``t.shed`` is bumped only on
        the in-lock paths (queue_full/pressure/eviction/shutdown): the
        pre-admission sheds (doa/breaker/injected) deliberately create
        no lane for a tenant the scheduler never admitted, so they
        count in the registry totals only."""
        reg = self._reg()
        reg.counter("serve.shed_total").inc()
        reg.counter(f"serve.shed.{cause}").inc()
        # shed-pressure stamp: the sidecar pool's hedged
        # dispatch auto-disarms within SRJTORCH_HEDGE_SHED_WINDOW_S of this
        # monotonic timestamp — an overloaded pool must not carry
        # duplicate load on top of the traffic it is already shedding
        reg.gauge("serve.last_shed_s").set(time.monotonic())

    @staticmethod
    def _shed_event(tenant: str, cause: str) -> None:
        metrics.event("serve.shed", tenant=tenant, cause=cause)

    def _overloaded(self, msg: str, cause: str,
                    retry_after_s: Optional[float] = None) -> Overloaded:
        return Overloaded(
            f"{self.name}: {msg}",
            retry_after_s=self._retry_after_s if retry_after_s is None
            else retry_after_s,
            cause=cause,
        )

    def _tenant_locked(self, name: str, weight) -> _Tenant:
        t = self._tenants.get(name)
        if t is None:
            if len(self._tenants) >= _LANE_PRUNE_AT:
                # high-cardinality tenant churn (per-user/session ids):
                # drop idle lanes (empty queue) so every dispatch scan
                # stays O(active tenants) and dead lane objects cannot
                # accumulate. A pruned tenant's counters live on in the
                # registry totals; a returning one re-enters at the
                # pass floor — no fairness credit lost or gained.
                for idle in [n for n, tt in self._tenants.items()
                             if not tt.q]:
                    del self._tenants[idle]
            t = _Tenant(name, 1.0 if weight is None else weight)
            # a new lane starts at the pass floor so it cannot claim
            # credit for the time it did not exist
            t.pass_ = self._pass_floor
            self._tenants[name] = t
            self._reg().gauge("serve.tenants").set(len(self._tenants))
        elif weight is not None:
            t.set_weight(weight)
        if not t.q:
            # idle -> busy: forfeit accumulated lag (stride discipline —
            # an hour-idle tenant must not monopolize the next hour)
            t.pass_ = max(t.pass_, self._pass_floor)
        return t

    def set_tenant_weight(self, tenant: str, weight: float) -> None:
        """Re-weight a tenant's fair share (stride = K / weight)."""
        with self._cond:
            self._tenant_locked(str(tenant), weight)

    def attach_cluster(self, cluster) -> None:
        """Attach a ``parallel.cluster.ClusterView``: while the cluster
        is below quorum (``has_quorum()`` false), every submit sheds
        retryable ``Overloaded(cause="cluster_degraded")`` — a cluster
        that cannot answer distributed queries correctly must refuse
        them upfront, not let them queue and fail mid-exchange. Pass
        None to detach."""
        with self._cond:
            self._cluster = cluster

    # -- admission (submit + the overload controller) ------------------------

    def submit(
        self,
        fn: Callable,
        *args,
        tenant: str = "default",
        deadline_s: Optional[float] = None,
        priority: int = 0,
        memory_bytes: Optional[int] = None,
        host_eligible: bool = True,
        weight: Optional[float] = None,
        idempotency_key: Optional[str] = None,
        recovered: bool = False,
        **kwargs,
    ) -> QueryHandle:
        """Admit one query (a callable or a CompiledPipeline — anything
        callable) for concurrent execution. Raises retryable
        ``Overloaded`` instead of queueing when admission must shed;
        see the module docstring for the cause taxonomy. ``deadline_s``
        starts at SUBMIT (queue wait spends it); an ambient deadline
        scope at the call site clamps it further and a dead one is
        rejected on arrival. ``memory_bytes`` pre-admits the whole
        query's footprint with the memory governor when it is armed
        (inner op boundaries then skip their own admission, the
        standard nesting discipline).

        With ``SRJTORCH_JOURNAL_DIR`` armed, a
        client-supplied ``idempotency_key`` whose journaled twin
        already reached DONE returns a pre-completed handle carrying a
        ``journal.DigestAnswer`` (no re-execution); otherwise the
        admitted query's submit record is fsync'd to the journal before
        this method returns. ``recovered=True`` marks a recovery
        resubmission — the trace ring annotates the restart seam."""
        plan_node = None
        if not callable(fn):
            # a logical-plan node is submittable
            # directly, with the bound tables dict as the sole
            # positional argument. Only TYPE-validated here — the
            # compile itself (rewrite fixpoint + host domain scans)
            # runs after the cheap pre-admission shed checks below, so
            # a breaker/injected/dead-budget shed never pays it.
            from ..plan import Node as _PlanNode

            if isinstance(fn, _PlanNode):
                if len(args) != 1 or not isinstance(args[0], dict):
                    raise TypeError(
                        "submitting a logical plan requires the bound "
                        "tables dict as the only positional argument"
                    )
                plan_node = fn
            else:
                raise TypeError(
                    f"submit() needs a callable, a compiled pipeline, or "
                    f"a logical plan, got {type(fn).__name__}"
                )
        tenant = str(tenant)
        # the root trace opens AT SUBMIT so the
        # queue wait is inside the query's span tree, and so every shed
        # — even a pre-admission one — reaches the flight recorder with
        # its cause. One boolean read (None back) when tracing is off.
        qt = tracing.start_trace(
            "serve.query", tenant=tenant, priority=int(priority)
        )
        # one env read when the journal is off
        # — the whole cost of the volatile posture
        from . import journal as journal_mod

        jrn = journal_mod.active()
        if recovered and qt is not None:
            # the restart seam: explain_last() on a resumed query shows
            # where the pre-crash lifetime ended and this one began
            qt.annotate(recovery=True)
        if idempotency_key is not None and jrn is not None:
            hit = jrn.done_digest(idempotency_key)
            if hit is not None:
                # the original completed before the crash: answer by
                # journaled digest, never re-execute DONE work
                jid, digest = hit
                self._reg().counter("journal.idempotent_hits").inc()
                with self._cond:
                    qid = next(self._ids)
                q = QueryHandle(self, None, (), {}, tenant, priority,
                                None, None, host_eligible, qid,
                                self._clock())
                q._state = S_DONE
                q._result = journal_mod.DigestAnswer(
                    idempotency_key, digest, jid
                )
                q._done.set()
                metrics.event(
                    "serve.idempotent_hit", query=qid, tenant=tenant,
                    idem=idempotency_key, jid=jid,
                )
                if qt is not None:
                    qt.annotate(idempotent_hit=True, jid=jid)
                    qt.finish("ok")
                return q
        # deterministic shed chaos: the `reject` kind keyed serve.admit
        try:
            faultinj.maybe_inject("serve.admit")
        except Overloaded:
            self._count_shed("injected")
            self._shed_event(tenant, "injected")
            _shed_trace(qt, "injected")
            raise
        # breaker- AND quarantine-aware routing: a dark pool
        # sheds only the work that CANNOT run on the host engine, and a
        # pool whose every live worker is QUARANTINED (gray, not dead —
        # the breaker never sees it) sheds the same way: queueing
        # device-only work onto known stragglers just converts sheds
        # into deadline expiries
        if not host_eligible:
            from .. import sidecar, sidecar_pool

            if sidecar.breaker().state() != "closed":
                self._count_shed("breaker")
                self._shed_event(tenant, "breaker")
                _shed_trace(qt, "breaker")
                raise self._overloaded(
                    "sidecar pool dark (breaker open) and query is not "
                    "host-engine-eligible", "breaker",
                )
            pool = sidecar_pool.current_pool()
            if (pool is not None and pool.live_count() > 0
                    and pool.routable_count() == 0):
                self._count_shed("quarantine")
                self._shed_event(tenant, "quarantine")
                _shed_trace(qt, "quarantine")
                raise self._overloaded(
                    "every live pool worker is quarantined (gray "
                    "failure) and query is not host-engine-eligible",
                    "quarantine",
                )
        # cluster-degraded shed: below quorum, a distributed
        # query cannot complete correctly — exchanges to dead ranks
        # would just burn retry budgets; refuse at admission instead,
        # retryable (quorum returns when replacements join)
        with self._cond:
            cluster = self._cluster
        if cluster is not None and not cluster.has_quorum():
            self._count_shed("cluster_degraded")
            self._shed_event(tenant, "cluster_degraded")
            _shed_trace(qt, "cluster_degraded")
            raise self._overloaded(
                f"cluster below quorum ({len(cluster.alive_ranks())}/"
                f"{cluster.world} ranks alive)", "cluster_degraded",
            )
        # dead-on-arrival deadline: fast-fail beats queueing work that
        # must expire (the effective budget inherits + clamps to an
        # ambient scope active at the submit site)
        outer = deadline_mod.current()
        eff = deadline_s if deadline_s is not None else deadline_mod.default_budget()
        if eff is not None:
            eff = float(eff)
        if outer is not None:
            rem = outer.remaining()
            if not math.isinf(rem):
                eff = rem if eff is None else min(eff, rem)
        if (eff is not None and eff <= 0) or (outer is not None and outer.done()):
            self._count_shed("doa_deadline")
            self._shed_event(tenant, "doa_deadline")
            _shed_trace(qt, "doa_deadline")
            raise self._overloaded(
                f"query dead on arrival (budget "
                f"{'cancelled' if outer is not None and outer.cancelled() else 'exhausted'} "
                "at submit)", "doa_deadline",
            )
        if plan_node is not None:
            # compile NOW, after the pre-admission sheds: the plan's
            # stage estimates must exist before queueing (memgov
            # pre-admission and the overload controller consume
            # memory_bytes), so the compile cannot move into the
            # dispatch slot
            from ..utils import knobs as _knobs

            if _knobs.get_bool("SRJTORCH_PLAN_CACHE"):
                # a parameterized-fingerprint hit skips
                # rewrite→verify→compile entirely and single-flights
                # identical concurrent submissions (the CachedQuery
                # wrapper also carries the structure's cost EWMA for
                # the forecast controller below)
                from .. import cache as _cache

                fn = _cache.compile_cached(
                    plan_node, args[0], name=f"serve.{tenant}"
                )
            else:
                from ..plan import compile_ir as _compile_ir

                fn = _compile_ir(plan_node, args[0], name=f"serve.{tenant}")
            args = ()
        if memory_bytes is None:
            # plan-derived pre-admission (ROADMAP item-2 follow-up):
            # compiled plans carry per-stage estimates — the scheduler's
            # memgov pre-admission and the overload controller see a
            # real footprint instead of a hand-fed number. An
            # out-of-core plan admits its
            # PER-PARTITION peak: the whole-plan estimate exceeds the
            # budget by construction, and admitting it would reject the
            # very strategy chosen to fit — the downgrade is counted.
            ooc_peak = getattr(fn, "partition_memory_bytes", None)
            if ooc_peak is not None and ooc_peak > 0:
                memory_bytes = ooc_peak
                self._reg().counter("memgov.ooc_admissions").inc()
            else:
                memory_bytes = getattr(fn, "estimated_memory_bytes", None)
        if memory_bytes is not None and memory_bytes <= 0:
            # a zero/negative estimate is not "needs no memory", it is
            # "no usable estimate": 0 would sail through memgov
            # pre-admission as a free query and starve real admissions
            # of their accounting — normalize to None (un-estimated)
            # and count the bad input
            self._reg().counter("serve.bad_estimate").inc()
            memory_bytes = None
        predicted_cost_s = getattr(fn, "predicted_cost_s", None)
        shed_exc: Optional[Overloaded] = None
        victim: Optional[QueryHandle] = None
        victim_cause: Optional[str] = None
        with self._cond:
            if not self._open:
                self._count_shed("shutting_down")
                shed_exc = self._overloaded(
                    "scheduler shutting down", "shutting_down",
                )
            else:
                t = self._tenant_locked(tenant, weight)
                now = self._clock()
                q = QueryHandle(self, fn, args, kwargs, tenant, priority,
                                eff, memory_bytes, host_eligible,
                                next(self._ids), now)
                q._predicted_cost_s = predicted_cost_s
                # admission shedding, lowest-priority-first, at most
                # ONE eviction per admitted query. The per-tenant bound
                # is the harder constraint and is checked first: an
                # eviction there keeps the GLOBAL queued count flat
                # too, so the pressure cap stays honored without a
                # second victim.
                if len(t.q) >= self._queue_depth:
                    # bounded per-tenant FIFO — never unbounded buffering
                    victim = self._evict_locked(t, q, "queue_full")
                    if victim is None:
                        t.shed += 1
                        self._count_shed("queue_full")
                        shed_exc = self._overloaded(
                            f"tenant {tenant!r} queue full "
                            f"({self._queue_depth} deep)", "queue_full",
                        )
                    else:
                        victim_cause = "queue_full"
                else:
                    # overload controller: global depth / queue age /
                    # memgov pressure shed lowest-priority-first
                    cause = self._pressure_cause_locked(
                        now, incoming_cost=predicted_cost_s
                    )
                    if cause is not None:
                        victim = self._evict_locked(None, q, cause)
                        if victim is None:
                            t.shed += 1
                            self._count_shed(cause)
                            shed_exc = self._overloaded(
                                f"overloaded ({cause}): {self._queued} "
                                f"queued, priority {priority} does not "
                                "outrank the queue", cause,
                            )
                        else:
                            victim_cause = cause
                if shed_exc is None:
                    if qt is not None:
                        # attach the trace BEFORE the handle becomes
                        # visible to a dispatcher: the notify below can
                        # wake a slot that runs the query immediately,
                        # and a late-published _trace would leave the
                        # root unfinished (annotate is dict writes —
                        # in-lock-safe; trace I/O stays outside)
                        qt.annotate(query=q.query_id, budget_s=eff)
                        q._trace = qt
                    if jrn is not None:
                        # the jid is published BEFORE the handle becomes
                        # dispatchable (string assignment only — journal
                        # I/O stays outside the lock): a slot that runs
                        # the query immediately must see it, or its
                        # DISPATCHED record would be lost
                        q._jid = f"{os.getpid()}-{q.query_id}"
                    t.q.append(q)
                    t.submitted += 1
                    self._queued += 1
                    reg = self._reg()
                    reg.counter("serve.submitted").inc()
                    reg.gauge("serve.queued").set(self._queued)
                    self._cond.notify()
        # event I/O (one file write per line) strictly OUTSIDE the
        # dispatch lock — a shed storm must not serialize admission and
        # dispatch behind the event log; trace finishing (span-log
        # writes, the flight-recorder flush) follows the same rule
        if victim is not None:
            self._shed_event(victim.tenant, victim_cause)
            _shed_trace(victim._trace, victim_cause)
            # an admitted-then-evicted query's lifecycle closes in the
            # journal too (outside the lock, before its waiters wake)
            self._journal_state(victim, S_SHED, cause=victim_cause)
            victim._done.set()
        if shed_exc is not None:
            self._shed_event(tenant, shed_exc.cause)
            _shed_trace(qt, shed_exc.cause)
            raise shed_exc
        if q._jid is not None:
            # the durable submit record, fsync'd BEFORE the handle is
            # returned: a coordinator that dies after this point can
            # replay the query; one that dies before it never handed
            # out a handle. Submit-time sheds above never journal —
            # they were never admitted.
            rec: Dict[str, Any] = {
                "jid": q._jid, "tenant": tenant,
                "priority": int(priority), "deadline_s": eff,
                "memory_bytes": memory_bytes,
                "host_eligible": bool(host_eligible),
            }
            if idempotency_key is not None:
                rec["idem"] = idempotency_key
            if recovered:
                rec["recovered"] = True
            bindings = None
            if plan_node is not None:
                from ..plan.rewrites import parameterized_fingerprint

                pf = parameterized_fingerprint(plan_node)
                bindings = journal_mod.sanitize_bindings(pf.bindings)
                if bindings is not None:
                    rec["pf"] = pf.key
                    rec["bindings"] = bindings
            if bindings is None:
                # plain callables (and plans with unslottable literals)
                # journal opaque: the lifecycle and idempotency index
                # still replay; recovery skips the resubmit
                rec["opaque"] = True
            jrn.append_submit(rec)
        metrics.event(
            "serve.submit", query=q.query_id, tenant=tenant,
            priority=priority, budget_s=eff,
        )
        return q

    def _pressure_cause_locked(self, now: float,
                               incoming_cost: Optional[float] = None,
                               ) -> Optional[str]:
        """The overload controller's trip decision: queue depth, queue
        age, memory-governor pressure, and predicted-cost
        forecast — admission-time only."""
        if self._max_queued > 0 and self._queued >= self._max_queued:
            return "pressure"
        from ..utils import knobs as _knobs

        budget = _knobs.get_float("SRJTORCH_SERVE_FORECAST_BUDGET_SEC")
        if budget is not None and budget > 0:
            # admission-cost forecast: cached plans carry an observed
            # run-cost EWMA; when the PREDICTED seconds of work already
            # queued plus this query exceed the budget, shed NOW at
            # queue depth 1-2 instead of after the queue is deep —
            # depth-based control can't see that two queued monsters
            # are worse than ten queued trivia. Unknown costs count 0:
            # the forecast only ever sheds on what it has evidence for.
            queued_cost = sum(
                (q._predicted_cost_s or 0.0)
                for t in self._tenants.values() for q in t.q
            )
            if queued_cost + (incoming_cost or 0.0) > budget:
                return "forecast"
        if self._queued:
            # per-tenant FIFO: each lane's head is its oldest entry,
            # so the global oldest is a min over heads, not a full scan
            oldest = min(
                (t.q[0]._t_submit for t in self._tenants.values() if t.q),
                default=None,
            )
            if oldest is not None and now - oldest > self._max_queue_age_s:
                return "pressure"
        # memgov blocked admissions == the device budget is the
        # bottleneck — but only a REAL backlog makes that an overload
        # signal: with fewer queued queries than dispatch slots the
        # bounded queues exist precisely to absorb the wait (a
        # momentary byte-wait must not shed a trickle tenant with an
        # empty queue). Gauge is registry-direct, 0 when the governor
        # never armed.
        if self._queued >= self._slots:
            from .. import memgov

            if (memgov.is_enabled()
                    and self._reg().value("memgov.queue_depth", 0) > 0):
                return "pressure"
        return None

    def _evict_locked(self, t: Optional[_Tenant], incoming: QueryHandle,
                      cause: str) -> Optional[QueryHandle]:
        """Lowest-priority-first shedding: evict the lowest-priority
        (latest-arrived on ties) QUEUED query — from tenant ``t``, or
        anywhere when None — iff ``incoming`` strictly outranks it.
        The victim's handle is finished with Overloaded and counted,
        but its done event and shed event are the CALLER's to fire
        after the lock is released. Returns the victim, or None when
        the incoming query may not displace anyone."""
        pool = (
            list(t.q) if t is not None
            else [q for tt in self._tenants.values() for q in tt.q]
        )
        if not pool:
            return None
        victim = min(pool, key=lambda q: (q.priority, -q._t_submit))
        if victim.priority >= incoming.priority:
            return None
        self._finish_locked(
            victim, S_SHED,
            self._overloaded(
                f"query {victim.query_id} shed at admission ({cause}): "
                f"priority {victim.priority} displaced by {incoming.priority}",
                cause,
            ),
        )
        self._tenants[victim.tenant].shed += 1
        self._count_shed(cause)
        return victim

    def _journal_state(self, q: QueryHandle, state: str,
                       result: Any = None, cause: Optional[str] = None,
                       ) -> None:
        """Append one state-transition record for an admitted query.
        One attribute read when the journal is
        off (``_jid`` is None); always called strictly OUTSIDE the
        dispatch lock — journal appends are fsync'd file I/O, governed
        by the same rule as every event write. A DONE record carries the
        result digest so a restarted coordinator answers the query's
        idempotency key without re-running it."""
        if q._jid is None:
            return
        from . import journal as journal_mod

        jrn = journal_mod.active()
        if jrn is None:
            return
        digest = None
        if state == S_DONE:
            digest = journal_mod.result_digest(result)
        jrn.append_state(q._jid, state, digest=digest, cause=cause)

    # -- completion bookkeeping ----------------------------------------------

    def _finish_locked(self, q: QueryHandle, state: str,
                       exc: Optional[BaseException],
                       result: Any = None) -> bool:
        """Move a handle to a final state (caller holds self._cond for
        queued handles; running handles complete through _complete).
        Deliberately does NOT set the done event: the caller releases
        waiters with ``q._done.set()`` only AFTER its counters/events
        land, so a ``result()`` returning implies the accounting is
        already visible."""
        if q._state in _FINAL:
            return False
        if q._state == S_QUEUED:
            try:
                self._tenants[q.tenant].q.remove(q)
            except (KeyError, ValueError):
                pass  # already popped by a dispatcher
            self._queued -= 1
            self._reg().gauge("serve.queued").set(self._queued)
        q._state = state
        q._exc = exc
        q._result = result
        return True

    def _complete(self, q: QueryHandle, state: str,
                  exc: Optional[BaseException], result: Any = None) -> None:
        reg = self._reg()
        with self._cond:
            if not self._finish_locked(q, state, exc, result):
                return
            t = self._tenants.get(q.tenant)  # pruned lanes: count global only
            if t is not None:
                if state == S_CANCELLED:
                    t.cancelled += 1
                elif state == S_DONE:
                    t.completed += 1
                else:
                    t.failed += 1
        if state == S_DONE:
            reg.counter("serve.completed").inc()
        elif state == S_CANCELLED:
            reg.counter("serve.cancelled").inc()
        else:
            reg.counter("serve.failed").inc()
        if metrics.is_enabled():
            now = self._clock()
            if q._t_dispatch is not None:
                metrics.histogram("serve.run_us").record(
                    (now - q._t_dispatch) * 1e6
                )
            metrics.histogram("serve.e2e_us").record(
                (now - q._t_submit) * 1e6
            )
        metrics.event(
            "serve.done", query=q.query_id, tenant=q.tenant, state=state,
            cls=None if exc is None else type(exc).__name__,
        )
        # durable terminal record BEFORE waiters wake: a result() that
        # returned implies the DONE digest is already journaled, so a
        # crash after the client read its answer still answers the
        # idempotency key by digest on restart
        self._journal_state(q, state, result=result)
        q._done.set()

    def _cancel(self, q: QueryHandle, reason: str) -> bool:
        where = None
        with self._cond:
            if q._state == S_QUEUED:
                q._token.cancel(reason)
                self._finish_locked(
                    q, S_CANCELLED,
                    DeadlineExceeded(
                        f"query {q.query_id}: cancelled in queue ({reason})"
                    ),
                )
                self._reg().counter("serve.cancelled").inc()
                t = self._tenants.get(q.tenant)
                if t is not None:
                    t.cancelled += 1
                where = "queued"
            elif q._state == S_RUNNING:
                # cooperative: the token rides the query's deadline
                # scope, so every layer beneath (retry backoffs,
                # shuffle escalations, sidecar socket deadlines) is a
                # cancel point — the slot frees when the fn unwinds
                q._token.cancel(reason)
                where = "running"
        if where is None:
            return False
        # event I/O outside the dispatch lock
        metrics.event(
            "serve.cancel", query=q.query_id, tenant=q.tenant,
            where=where, reason=reason,
        )
        if where == "queued":
            qt = q._trace
            if qt is not None:
                qt.annotate(cancel_reason=reason)
                qt.finish("cancelled")
            self._journal_state(q, S_CANCELLED, cause=reason)
            q._done.set()
        return True

    # -- the dispatcher ------------------------------------------------------

    def _worker_loop(self) -> None:
        while True:
            expired: List[QueryHandle] = []
            q = None
            exiting = False
            with self._cond:
                while True:
                    q = self._pop_locked(expired)
                    if q is not None:
                        break
                    if not self._open and not any(
                        t.q for t in self._tenants.values()
                    ):
                        exiting = True
                        break
                    if expired:
                        # flush the expiry events (file I/O) outside
                        # the lock before going back to sleep
                        break
                    # every wake condition notifies (submit, shutdown,
                    # slot release); the timeout is a safety net, not a
                    # poll — long enough that idle slots cost ~nothing
                    self._cond.wait(0.5)
                if q is not None:
                    q._state = S_RUNNING
                    q._t_dispatch = self._clock()
                    self._running += 1
                    self._inflight.add(q)
                    self._reg().gauge("serve.running").set(self._running)
            for e in expired:  # counters landed in-lock; events + wakeups here
                metrics.event(
                    "serve.expired_in_queue", query=e.query_id,
                    tenant=e.tenant, budget_s=e._budget_s,
                )
                if e._trace is not None:
                    e._trace.annotate(expired_in_queue=True)
                    e._trace.finish("expired")
                self._journal_state(e, S_EXPIRED)
                e._done.set()
            if q is None:
                if exiting:
                    return
                continue
            try:
                self._run(q)
            finally:
                with self._cond:
                    self._running -= 1
                    self._inflight.discard(q)
                    self._reg().gauge("serve.running").set(self._running)
                    self._cond.notify_all()

    def _pop_locked(self, expired_out: List[QueryHandle]) -> Optional[QueryHandle]:
        """Stride scheduling over the non-empty tenant lanes, expiring
        dead-budget entries on the way (they never dispatch). Expired
        handles are fully accounted here (state/exc/counters) but
        appended to ``expired_out`` — the caller fires their events and
        done wakeups after releasing the lock."""
        while True:
            best = None
            for t in self._tenants.values():
                if t.q and (best is None or t.pass_ < best.pass_):
                    best = t
            if best is None:
                return None
            q = best.q.popleft()
            if q._state != S_QUEUED:
                continue  # finished while queued (cancel/shed race)
            now = self._clock()
            if q._t_deadline is not None and now >= q._t_deadline:
                # expired while queued: counted, completed, never run —
                # accounting lands BEFORE the done event releases any
                # result() waiter
                self._queued -= 1
                self._reg().gauge("serve.queued").set(self._queued)
                q._state = S_EXPIRED
                q._exc = DeadlineExceeded(
                    f"query {q.query_id}: budget "
                    f"({q._budget_s:g}s) expired in queue"
                )
                self._reg().counter("serve.expired_in_queue").inc()
                self._reg().counter("serve.failed").inc()
                t = self._tenants.get(q.tenant)
                if t is not None:
                    t.expired += 1
                expired_out.append(q)
                continue
            self._queued -= 1
            self._reg().gauge("serve.queued").set(self._queued)
            # the floor is the PRE-increment pass (the minimum over
            # non-empty lanes): entering lanes seed from it, and a
            # post-increment floor would let one low-weight dispatch
            # (huge stride) vault it far ahead, starving every tenant
            # that enters at the floor behind the whole backlog
            self._pass_floor = best.pass_
            best.pass_ += best.stride
            return q

    def _run(self, q: QueryHandle) -> None:
        # the slot thread installs the query's
        # trace context for the fn's whole dynamic extent (op spans,
        # memgov admission waits, pool requests, wire hops all nest
        # under it), records the queue wait as a closed span, and
        # finishes the root from the handle's final state AFTER the run
        # span closed — so the in-memory tree explain_last() renders is
        # complete before the recorder sees it.
        qt = q._trace
        if qt is None:
            self._run_inner(q)
            return
        with qt.activate():
            tracing.closed_span(
                "serve.queue_wait",
                max(q._t_dispatch - q._t_submit, 0.0),
                tenant=q.tenant,
            )
            try:
                with tracing.span(
                    "serve.run", query=q.query_id, tenant=q.tenant
                ):
                    self._run_inner(q)
            finally:
                qt.finish(_TRACE_STATUS.get(q._state, q._state))

    def _run_inner(self, q: QueryHandle) -> None:
        from .. import memgov

        if metrics.is_enabled():
            metrics.histogram("serve.queue_wait_us").record(
                (q._t_dispatch - q._t_submit) * 1e6
            )
        metrics.event(
            "serve.dispatch", query=q.query_id, tenant=q.tenant,
            wait_us=round((q._t_dispatch - q._t_submit) * 1e6, 1),
        )
        # DISPATCHED is journaled after-the-fact (the slot thread,
        # outside the dispatch lock): replay distinguishes queued-only
        # work from work that may have partially executed — both
        # resubmit, but the seam is visible in the replayed lifecycle
        self._journal_state(q, "dispatched")
        budget = None
        if q._t_deadline is not None:
            # remaining after the queue wait; an expiry between pop and
            # here still yields a valid (instantly done) scope
            budget = max(q._t_deadline - self._clock(), 1e-6)
        adm = None
        try:
            with deadline_mod.scope(budget, token=q._token) as d:
                d.check(f"serve.query.{q.query_id}")
                if q._memory_bytes is not None and memgov.is_enabled():
                    # whole-query pre-admission: inner op boundaries
                    # see the held admission and skip their own (the
                    # memgov nesting discipline)
                    adm = memgov.admit(
                        f"serve.{q.tenant}", (), {}, q._memory_bytes
                    )
                try:
                    res = q._fn(*q._args, **q._kwargs)
                finally:
                    if adm is not None:
                        adm.release()
            self._complete(q, S_DONE, None, res)
        except BaseException as e:  # srjt-lint: allow-broad-except(dispatch slot: EVERY query failure — taxonomy, host-side, even SystemExit from user code — must land in the handle for result() to re-raise, or the waiter hangs forever; the slot itself must survive to serve the next query, so nothing re-raises out of a worker thread)
            state = S_FAILED
            if isinstance(e, DeadlineExceeded) and q._token.cancelled():
                state = S_CANCELLED
            self._complete(q, state, e)

    # -- shutdown ------------------------------------------------------------

    def shutdown(self, drain: bool = True,
                 timeout_s: Optional[float] = None) -> bool:
        """Stop admitting (subsequent submits raise
        ``Overloaded(shutting_down)``) and JOIN every dispatch slot.
        ``drain=True`` runs the queue dry first; ``drain=False``
        completes every queued handle with ``Overloaded(shutting_down)``
        and trips every in-flight query's cancel token, then joins the
        unwinding slots. Returns True when no thread leaked
        (``timeout_s`` bounds the join; a False return leaves the
        scheduler in the leak report)."""
        shed_queued: List[QueryHandle] = []
        with self._cond:
            already = not self._open
            self._open = False
            if not drain:
                for t in self._tenants.values():
                    for q in [qq for qq in t.q if qq._state == S_QUEUED]:
                        self._finish_locked(
                            q, S_SHED,
                            self._overloaded(
                                f"query {q.query_id}: scheduler shutting "
                                "down", "shutting_down",
                            ),
                        )
                        t.shed += 1
                        self._count_shed("shutting_down")
                        shed_queued.append(q)
                for q in self._inflight:
                    q._token.cancel("scheduler shutdown")
            self._cond.notify_all()
        for q in shed_queued:  # event I/O + wakeups outside the lock
            self._shed_event(q.tenant, "shutting_down")
            _shed_trace(q._trace, "shutting_down")
            self._journal_state(q, S_SHED, cause="shutting_down")
            q._done.set()
        t_end = None if timeout_s is None else time.monotonic() + timeout_s
        for w in self._workers:
            w.join(
                None if t_end is None
                else max(t_end - time.monotonic(), 0.001)
            )
        leaked = [w.name for w in self._workers if w.is_alive()]
        if not leaked:
            with _live_lock:
                _LIVE.discard(self)
        if not already:
            metrics.event(
                "serve.shutdown", scheduler=self.name, drain=drain,
                leaked_threads=len(leaked),
            )
        return not leaked

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown(drain=exc == (None, None, None))

    # -- observability -------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-clean state for stats_report / tests."""
        with self._cond:
            return {
                "name": self.name,
                "open": self._open,
                "slots": self._slots,
                "running": self._running,
                "queued": self._queued,
                "queue_depth": self._queue_depth,
                "max_queued": self._max_queued,
                "max_queue_age_s": self._max_queue_age_s,
                "tenants": {
                    t.name: {
                        "queued": len(t.q),
                        "weight": t.weight,
                        "submitted": t.submitted,
                        "completed": t.completed,
                        "failed": t.failed,
                        "shed": t.shed,
                        "expired": t.expired,
                        "cancelled": t.cancelled,
                    }
                    for t in self._tenants.values()
                },
            }


# ---------------------------------------------------------------------------
# process-wide default scheduler + leak accounting
# ---------------------------------------------------------------------------

_live_lock = threading.Lock()
_LIVE: set = set()
_ever_created = False
_default: Optional[Scheduler] = None
_default_lock = threading.Lock()


def scheduler(**kwargs) -> Scheduler:
    """The process-wide default scheduler (lazy; kwargs only apply on
    first creation)."""
    global _default
    sch = _default  # one unlocked read: a concurrent shutdown may null
    if sch is None or not sch._open:  # the global between two reads
        with _default_lock:
            sch = _default
            if sch is None or not sch._open:
                sch = _default = Scheduler(**kwargs)
    return sch


def submit(fn, *args, **kwargs) -> QueryHandle:
    """``serve.submit(...)``: submit to the default scheduler."""
    return scheduler().submit(fn, *args, **kwargs)


def shutdown_scheduler(drain: bool = True,
                       timeout_s: Optional[float] = None) -> None:
    """Tear down the default scheduler (tests, process exit)."""
    global _default
    with _default_lock:
        sch, _default = _default, None
    if sch is not None:
        sch.shutdown(drain=drain, timeout_s=timeout_s)


def live_scheduler_count() -> int:
    """Schedulers whose worker threads have not all been joined — the
    session-scoped leak assertion in the test suite reads this."""
    with _live_lock:
        return len(_LIVE)


def leak_report() -> List[str]:
    with _live_lock:
        scheds = list(_LIVE)
    return [
        f"{s.name}: open={s._open} queued={s._queued} "
        f"running={s._running} threads="
        f"{[w.name for w in s._workers if w.is_alive()]}"
        for s in scheds
    ]


def stats_section() -> Optional[dict]:
    """The ``serve`` section of runtime.stats_report(): None until a
    scheduler has ever existed (a stats poll never instantiates one),
    else the durable registry counters plus every live scheduler's
    snapshot."""
    if not _ever_created:
        return None
    reg = metrics.registry()
    out = {
        "submitted": reg.value("serve.submitted"),
        "completed": reg.value("serve.completed"),
        "failed": reg.value("serve.failed"),
        "cancelled": reg.value("serve.cancelled"),
        "expired_in_queue": reg.value("serve.expired_in_queue"),
        "shed_total": reg.value("serve.shed_total"),
        "shed": {c: reg.value(f"serve.shed.{c}") for c in SHED_CAUSES},
    }
    with _live_lock:
        scheds = list(_LIVE)
    out["schedulers"] = [s.snapshot() for s in scheds]
    return out
