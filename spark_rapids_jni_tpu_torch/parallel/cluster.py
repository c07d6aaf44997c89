"""Cluster membership, liveness and generation-fenced recovery for an
N-rank TCP exchange (port of the JAX package's ``parallel/cluster.py``).

A ``ClusterView`` owns the rank -> address map of the fabric, probes
every peer with ``TcpExchange.ping`` heartbeats, keeps an EWMA of their
round trips and walks each peer through ``ALIVE -> SUSPECT -> DEAD`` on
consecutive misses. A death is a membership event: it bumps the cluster
generation, which the exchange stamps into every fenced fetch and serve,
so bytes from a rank still serving an older world view are refused
undecoded and reach the puller as a retryable desync, never as rows.

Recovery replays lineage: ``lineage(rank)`` reproduces a dead rank's
input shard. ``recover_partition`` repartitions it (``hash_partition``,
so one INT32 or INT64 key runs B1) and republishes the dead rank's
outgoing partitions at ``epoch + (dead_rank+1) * 2^24`` under the bumped
generation; ``failover_fetch`` is the pull side's entry once a peer's
retries are spent; ``recompute_dead_partition`` rebuilds the partition
that was headed to the dead rank from every rank's lineage. The
recomputation runs in the thread that needs it, on the device of the
tables ``lineage`` returns.

State machine::

    ALIVE --misses >= SRJTORCH_CLUSTER_SUSPECT_MISSES--> SUSPECT
    SUSPECT --misses >= SRJTORCH_CLUSTER_DEAD_MISSES--> DEAD (generation = 1 + deaths)
    SUSPECT --one successful ping--> ALIVE (misses reset)
    DEAD is terminal for the generation.

Threads: one daemon heartbeat thread a view, which does host socket work
only; all state sits behind one lock and condition (``await_dead``
waiters wake on every transition). Cadence, timeout, thresholds and
quorum come from the ``SRJTORCH_CLUSTER_*`` knobs.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from ..columnar import Table
from ..utils import knobs, metrics, tracing
from ..utils.errors import FatalDeviceError

__all__ = ["ALIVE", "SUSPECT", "DEAD", "ClusterView"]

ALIVE = "alive"
SUSPECT = "suspect"
DEAD = "dead"


class ClusterView:
    """Membership, liveness and recovery for one rank of an N-rank
    exchange. ``addresses`` maps every rank, ``rank`` included, to
    ``host:port``. Construction installs generation 1 into the exchange;
    ``start()`` launches the heartbeat thread (a view driven by hand
    through ``mark_dead`` may skip it)."""

    def __init__(self, rank: int, addresses: Dict[int, str], exchange, *,
                 lineage: Optional[Callable[[int], Table]] = None,
                 on_transition: Optional[Callable[[int, str, str], None]] = None,
                 heartbeat_s: Optional[float] = None,
                 heartbeat_timeout_s: Optional[float] = None,
                 suspect_misses: Optional[int] = None,
                 dead_misses: Optional[int] = None,
                 quorum_fraction: Optional[float] = None) -> None:
        if rank not in addresses:
            raise ValueError(f"cluster addresses must include this rank {rank} "
                             f"(got ranks {sorted(addresses)})")
        self.rank = int(rank)
        self.addresses = dict(addresses)
        self.world = len(self.addresses)
        self._exchange = exchange
        self._lineage = lineage
        self._on_transition = on_transition

        def knob(value, getter, name):
            return getter(name) if value is None else value

        self.heartbeat_s = float(knob(heartbeat_s, knobs.get_float,
                                      "SRJTORCH_CLUSTER_HEARTBEAT_SEC"))
        self.heartbeat_timeout_s = float(knob(heartbeat_timeout_s, knobs.get_float,
                                              "SRJTORCH_CLUSTER_HEARTBEAT_TIMEOUT_SEC"))
        self.suspect_misses = int(knob(suspect_misses, knobs.get_int,
                                       "SRJTORCH_CLUSTER_SUSPECT_MISSES"))
        self.dead_misses = int(knob(dead_misses, knobs.get_int, "SRJTORCH_CLUSTER_DEAD_MISSES"))
        self.quorum_fraction = float(knob(quorum_fraction, knobs.get_float,
                                          "SRJTORCH_CLUSTER_QUORUM_FRACTION"))
        if self.dead_misses < self.suspect_misses:
            raise ValueError(
                f"SRJTORCH_CLUSTER_DEAD_MISSES ({self.dead_misses}) must be >= "
                f"SRJTORCH_CLUSTER_SUSPECT_MISSES ({self.suspect_misses})")
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._generation = 1
        self._state: Dict[int, str] = {r: ALIVE for r in self.addresses if r != self.rank}
        self._misses: Dict[int, int] = {r: 0 for r in self._state}
        # heartbeat round trips for operators; liveness stays a hard count
        self._rtt = metrics.KeyedEwma(alpha=0.3)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._recovered_epochs: set = set()
        exchange.set_generation(self._generation)
        metrics.registry().gauge("cluster.generation").set(self._generation)
        metrics.registry().gauge("cluster.alive").set(self.world)

    # -- membership readers -------------------------------------------------

    def generation(self) -> int:
        with self._lock:
            return self._generation

    def state(self, rank: int) -> str:
        with self._lock:
            if rank == self.rank:
                return ALIVE
            return self._state[rank]

    def alive_ranks(self) -> List[int]:
        with self._lock:
            alive = [r for r, s in self._state.items() if s != DEAD]
            return sorted(alive + [self.rank])

    def dead_ranks(self) -> List[int]:
        with self._lock:
            return sorted(r for r, s in self._state.items() if s == DEAD)

    def has_quorum(self) -> bool:
        """True while strictly more than ``quorum_fraction`` of the world
        is not DEAD."""
        return len(self.alive_ranks()) > self.quorum_fraction * self.world

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {
                "rank": self.rank,
                "world": self.world,
                "generation": self._generation,
                "states": dict(self._state),
                "rtt_ms": {r: self._rtt.get(str(r)) for r in self._state},
            }

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            raise FatalDeviceError("ClusterView.start called twice")
        self._thread = threading.Thread(target=self._heartbeat_loop,
                                        name=f"cluster-hb-r{self.rank}", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=self.heartbeat_timeout_s + self.heartbeat_s + 1.0)
        self._thread = None

    def set_lineage(self, fn: Callable[[int], Table]) -> None:
        """Install the input reproducer: ``fn(rank)`` returns the table that
        rank fed into the exchange. Without it ``failover_fetch`` answers
        None and the pull keeps its own error."""
        with self._lock:
            self._lineage = fn

    # -- heartbeat engine ---------------------------------------------------

    def _heartbeat_loop(self) -> None:
        # Event.wait is the cadence: stop() interrupts it
        while not self._stop.wait(self.heartbeat_s):
            for r, addr in self.addresses.items():
                if r == self.rank or self._stop.is_set():
                    continue
                with self._lock:
                    if self._state[r] == DEAD:
                        continue
                self._probe(r, addr)

    def _probe(self, r: int, addr: str) -> None:
        t0 = time.monotonic()
        try:
            peer_gen = self._exchange.ping(addr, self.heartbeat_timeout_s)
        except Exception as e:  # srjt-lint: allow-broad-except(heartbeat probe: ANY ping failure is one miss — classification happens at the miss-count threshold, not per-exception)
            self._record_miss(r, e)
            return
        rtt_ms = (time.monotonic() - t0) * 1e3
        with self._lock:
            self._rtt.update(str(r), rtt_ms)
        self._record_hit(r, peer_gen)

    def _record_hit(self, r: int, peer_gen: int) -> None:
        with self._lock:
            self._misses[r] = 0
            if self._state[r] == SUSPECT:
                self._transition_locked(r, SUSPECT, ALIVE)
            # a peer that already saw a death is ahead of us: publishing
            # under our older generation would get our bytes refused
            if peer_gen > self._generation:
                self._bump_generation_locked(peer_gen)

    def _record_miss(self, r: int, exc: BaseException) -> None:
        with self._lock:
            if self._state[r] == DEAD:
                return
            self._misses[r] += 1
            n = self._misses[r]
            if self._state[r] == ALIVE and n >= self.suspect_misses:
                self._transition_locked(r, ALIVE, SUSPECT, reason=repr(exc))
            if self._state[r] == SUSPECT and n >= self.dead_misses:
                self._declare_dead_locked(r, reason=repr(exc))

    def _transition_locked(self, r: int, old: str, new: str, reason: str = "") -> None:
        self._state[r] = new
        metrics.registry().counter("cluster.transitions").inc()
        metrics.event("cluster.transition", rank=r, old=old, new=new,
                      generation=self._generation, observer=self.rank, reason=reason)
        cb = self._on_transition
        self._cond.notify_all()
        if cb is not None:
            cb(r, old, new)

    def _declare_dead_locked(self, r: int, reason: str = "") -> None:
        self._transition_locked(r, self._state[r], DEAD, reason=reason)
        metrics.registry().counter("cluster.deaths").inc()
        dead = sum(1 for s in self._state.values() if s == DEAD)
        metrics.registry().gauge("cluster.alive").set(self.world - dead)
        # the generation is a function of membership (1 + deaths known), so
        # every view that learns of one death lands on the same number
        target = 1 + dead
        if target > self._generation:
            self._bump_generation_locked(target)

    def _bump_generation_locked(self, new_gen: int) -> None:
        self._generation = int(new_gen)
        self._exchange.set_generation(self._generation)
        metrics.registry().gauge("cluster.generation").set(self._generation)
        self._cond.notify_all()

    # -- coordinator hooks --------------------------------------------------

    def mark_dead(self, r: int) -> None:
        """Force a rank DEAD (a death observed out of band, e.g. a reaped
        process), through the heartbeat detector's transitions."""
        with self._lock:
            if self._state[r] == DEAD:
                return
            if self._state[r] == ALIVE:
                self._transition_locked(r, ALIVE, SUSPECT, reason="marked dead out of band")
            self._declare_dead_locked(r, reason="marked dead out of band")

    def await_dead(self, r: int, timeout_s: float) -> bool:
        """Block until ``r`` is DEAD or the timeout passes; returns whether
        it died."""
        until = time.monotonic() + max(float(timeout_s), 0.0)
        with self._cond:
            while self._state[r] != DEAD:
                remaining = until - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(remaining)
            return True

    # -- recovery -----------------------------------------------------------

    def failover_grace_s(self) -> float:
        """How long a failed pull waits for the detector to confirm a
        death: the whole miss ladder, one probe timeout and slack."""
        return self.dead_misses * self.heartbeat_s + self.heartbeat_timeout_s + 1.0

    def _lineage_fn(self):
        with self._lock:
            return self._lineage

    def failover_fetch(self, dead_rank: int, epoch: int, key_cols: List[str], world: int,
                       dest: int) -> Optional[Table]:
        """The pull side's recovery entry: once ``dead_rank`` is confirmed
        DEAD within the grace and a lineage is installed, recompute its
        partitions and return the one headed for ``dest``. None means not
        dead (or unrecoverable): the caller re-raises its own error."""
        if not self.await_dead(dead_rank, self.failover_grace_s()):
            return None
        if self._lineage_fn() is None:
            return None
        return self.recover_partition(dead_rank, epoch, key_cols, world, dest)

    def recover_partition(self, dead_rank: int, epoch: int, key_cols: List[str], world: int,
                          dest: int) -> Table:
        """Recompute ``dead_rank``'s exchange input from lineage, partition
        it, republish its outgoing partitions at the recovery epoch under
        the bumped generation (once a dead rank and epoch on this view),
        and return the partition headed for ``dest``."""
        from ..ops.copying import slice_table
        from .shuffle import _RECOVERY_EPOCH_STRIDE, hash_partition

        lineage = self._lineage_fn()
        if lineage is None:
            raise FatalDeviceError(f"cluster recovery for rank {dead_rank} has no lineage")
        recovery_epoch = int(epoch) + (dead_rank + 1) * _RECOVERY_EPOCH_STRIDE
        with tracing.span("cluster.recover_partition", dead_rank=dead_rank, epoch=epoch,
                          dest=dest):
            partitioned, offsets = hash_partition(lineage(dead_rank), world, key_cols)
            bounds = list(offsets) + [partitioned.num_rows]
            parts = {p: slice_table(partitioned, bounds[p], bounds[p + 1]) for p in range(world)}
            with self._lock:
                first = (dead_rank, int(epoch)) not in self._recovered_epochs
                self._recovered_epochs.add((dead_rank, int(epoch)))
            if first:
                self._exchange.publish(recovery_epoch,
                                       {p: t for p, t in parts.items() if p != dead_rank})
                metrics.registry().counter("cluster.recoveries").inc()
                metrics.event("cluster.recovery", dead_rank=dead_rank, epoch=epoch,
                              recovery_epoch=recovery_epoch, generation=self.generation(),
                              by=self.rank)
        return parts[dest]

    def recompute_dead_partition(self, dead_rank: int, key_cols: List[str],
                                 world: int) -> Table:
        """The destination-side hole: rebuild the partition that was headed
        to the dead rank from every rank's lineage, so that a coordinator
        can finish the dead rank's share. Lineage replay, no network."""
        from ..ops.copying import concatenate, slice_table
        from .shuffle import hash_partition

        lineage = self._lineage_fn()
        if lineage is None:
            raise FatalDeviceError(f"cluster recompute for rank {dead_rank} has no lineage")
        full = concatenate([lineage(r) for r in range(world)])
        partitioned, offsets = hash_partition(full, world, key_cols)
        bounds = list(offsets) + [partitioned.num_rows]
        return slice_table(partitioned, bounds[dead_rank], bounds[dead_rank + 1])
