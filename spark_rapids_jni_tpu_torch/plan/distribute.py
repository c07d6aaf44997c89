"""Distributed plan assembly: Exchange insertion + run-time binding (port
of the JAX package's ``plan/distribute.py``, bound to the port's
``TcpExchange``).

The two halves of "compiled plans gain exchange stages":

**insert_exchanges(plan, world)** is the *structural* half — a
deterministic tree rebuild that wraps every keyed Aggregate's input in
an ``Exchange`` on the grouping keys, so each rank aggregates only the
key space hashed to it. It is deliberately NOT a registered rewrite
rule: rewrite rules are semantics-preserving *per-process* transforms
with translation-validation obligations, while Exchange changes
where rows live, which is only meaning-preserving under the N-rank
execution contract this module owns. Joins stay local: the shard
binding replicates every non-sharded table on every rank (broadcast
join), so only the aggregate's key space needs movement — the same
shape Spark picks for a fact-table scan joined to small dims.

**exchange_context(...)** is the *runtime* half — a contextvar-scoped
binding from the logical Exchange stages to a concrete
``TcpExchange`` + peer map (+ optional ``ClusterView`` for fenced
recovery). Outside any binding — or at ``world == 1`` — an Exchange
stage is the identity, so the SAME compiled plan runs single-host
(plancheck, tests, the oracle side of the chaos gate) and distributed
without recompilation. Stage epochs are allocated in first-run order,
which the compiled plan makes deterministic and identical on every
rank; each stage gets its own epoch namespace
(``base_epoch + i * _STAGE_EPOCH_STRIDE``) so two exchange stages in
one plan can never collide in the publish store.

Recovery lineage: with a cluster AND ``shard_tables`` bound, each
Exchange stage installs ``lineage(r) = replay my child subtree over
rank r's catalog shard`` just before it moves rows — the Spark
lineage story, but the replay is the already-lowered exec subtree, so
a dead rank's exchange input is recomputed by exactly the code that
produced the original.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Dict, Optional

from ..columnar import Table
from .exprs import PlanError
from .nodes import Aggregate, Exchange, Node
from .rewrites import _with_inputs

__all__ = ["insert_exchanges", "exchange_context", "current_binding",
           "merge_partials",
           "ExchangeBinding"]

# one epoch namespace per exchange stage; a worker's own result
# publishes ride base_epoch + 1, which stage 0 (base_epoch) and stage
# 1 (base_epoch + 16) both clear
_STAGE_EPOCH_STRIDE = 16


def insert_exchanges(plan: Node, world: int) -> Node:
    """Rebuild ``plan`` with an ``Exchange(keys, world)`` under every
    keyed Aggregate. Shared subtrees stay shared (memo by identity,
    the same discipline as the rewrite pass); non-keyed aggregates are
    left alone — a global aggregate has no partitioning to exploit and
    its distribution is the coordinator's merge problem."""
    if world < 1:
        raise PlanError(f"insert_exchanges: world must be >= 1, got {world}")
    memo: Dict[int, Node] = {}

    def walk(n: Node) -> Node:
        if id(n) in memo:
            return memo[id(n)]
        kids = tuple(walk(i) for i in n.inputs())
        if isinstance(n, Aggregate) and n.keys:
            out: Node = Aggregate(
                Exchange(kids[0], tuple(n.keys), world),
                keys=n.keys, aggs=n.aggs, grouping_sets=n.grouping_sets,
            )
        else:
            out = _with_inputs(n, kids)
        memo[id(n)] = out
        return out

    return walk(plan)


def merge_partials(partials, sort_keys) -> Table:
    """Coordinator-side merge of per-rank results: concatenate and
    re-apply the plan's Sort keys (``((column, ascending), ...)``).
    Bit-identical to the single-host run whenever (a) the exchange
    made every rank's groups complete — true by construction — and (b) the
    sort keys form a total order (the distributed TPC-DS plans end in
    one: the group key breaks ties)."""
    from ..ops.copying import concatenate
    from ..ops.sort import sort_by_key

    merged = concatenate(list(partials))
    if not sort_keys:
        return merged
    keys = Table([merged.column(c) for c, _ in sort_keys],
                 [f"k{i}" for i in range(len(sort_keys))])
    return sort_by_key(merged, keys,
                       ascending=[asc for _, asc in sort_keys])


class ExchangeBinding:
    """The concrete fabric a plan's Exchange stages run against:
    ``exchange`` (a TcpExchange), ``peers`` (rank -> host:port, this
    rank excluded), optional ``cluster`` (ClusterView: fencing +
    failover) and ``shard_tables`` (rank -> catalog shard, the lineage
    reproducer)."""

    def __init__(self, exchange, peers: Dict[int, str], *,
                 cluster=None,
                 shard_tables: Optional[Callable[[int], Dict[str, Table]]] = None,
                 base_epoch: int = 0) -> None:
        self.exchange = exchange
        self.peers = dict(peers)
        self.cluster = cluster
        self.shard_tables = shard_tables
        self.base_epoch = int(base_epoch)
        self._stage_epochs: Dict[int, int] = {}

    @property
    def world(self) -> int:
        return len(self.peers) + 1

    def stage_epoch(self, stage_id: int) -> int:
        """Deterministic per-stage epoch: allocated in first-run
        order, which the compiled plan's data dependencies make
        identical on every rank."""
        if stage_id not in self._stage_epochs:
            self._stage_epochs[stage_id] = (
                self.base_epoch + len(self._stage_epochs) * _STAGE_EPOCH_STRIDE
            )
        return self._stage_epochs[stage_id]


_BINDING: contextvars.ContextVar[Optional[ExchangeBinding]] = \
    contextvars.ContextVar("srjt_exchange_binding", default=None)


def current_binding() -> Optional[ExchangeBinding]:
    return _BINDING.get()


@contextlib.contextmanager
def exchange_context(exchange, peers: Dict[int, str], *,
                     cluster=None,
                     shard_tables: Optional[Callable[[int], Dict[str, Table]]] = None,
                     base_epoch: int = 0):
    """Bind the plan compiler's Exchange stages to a live fabric for
    the dynamic extent of the block (contextvar-scoped: thread- and
    task-local, exactly like the deadline scopes)."""
    token = _BINDING.set(ExchangeBinding(
        exchange, peers, cluster=cluster, shard_tables=shard_tables,
        base_epoch=base_epoch,
    ))
    try:
        yield
    finally:
        _BINDING.reset(token)
