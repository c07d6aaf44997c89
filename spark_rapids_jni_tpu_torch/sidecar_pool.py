"""Crash-tolerant sidecar worker POOL over a SLAB-ARENA data plane: the
port of the JAX package's ``sidecar_pool.py``.

- **ArenaSlab**: one memfd of ``SRJTORCH_ARENA_SLAB_BYTES`` (a power of
  two; every worker maps the same pages) carved by a buddy free-list
  into power-of-two regions. Each in-flight request LEASES a region,
  writes its payload behind the 32-byte region header (magic +
  generation + request id + capacity + payload length), and the worker
  answers back into the same region. Exhaustion raises the retryable
  ``RESOURCE_EXHAUSTED`` so retry-with-split engages; every open slab is
  registered (``open_slab_count``, ``arena_leak_report``).
- **SidecarPool**: N supervised workers (``spawn_worker`` on the card by
  default, ``device="cpu"`` when asked), routed round-robin over the
  LIVE set; a worker death is one ``sidecar.pool.failovers`` and a
  background respawn with SET_ARENA re-hydration; the process-global
  breaker records a failure only when the WHOLE pool is dark.
- **Gray-failure quarantine**: a worker collecting
  ``SRJTORCH_QUARANTINE_STRIKES`` net slow samples (each slower than
  ``SRJTORCH_QUARANTINE_SLOW_FACTOR`` x the pool-wide op-class p50, or a
  timeout) leaves preferred routing, is probed in the background, and is
  reinstated after ``SRJTORCH_QUARANTINE_PROBES`` clean probes.
- **Hedged dispatch** (``_race``): a request outliving the op-class p95
  launches ONE duplicate on a different healthy worker; first valid
  response wins, within ``SRJTORCH_HEDGE_BUDGET_PCT`` of pool calls, and
  never under memgov pressure or within ``SRJTORCH_HEDGE_SHED_WINDOW_S``
  of a serve-layer shed.
- **Host-engine degrade**: when the device path cannot answer (breaker
  open, or every attempt failed with the taxonomy's DeviceError), the op
  runs in this process through ``sidecar._dispatch`` on the CPU, chosen
  explicitly; it is counted (``sidecar.pool.host_fallbacks`` and
  ``sidecar.host_fallbacks``) and annotates the ``pool.call`` span with
  ``host_fallback``.

Observability is registry-direct under the reference's names
(``sidecar.pool.*``), and ``runtime.stats_report()`` carries the
``pool``, ``health`` and ``hedge`` sections.
"""

from __future__ import annotations

import functools
import mmap
import os
import struct
import threading
import time
from typing import Dict, List, Optional

from . import sidecar
from .sidecar import (
    ARENA_MODE_SLAB,
    OP_SET_ARENA,
    REGION_HDR,
    REGION_HDR_LEN,
    REGION_MAGIC,
    STATUS_OK,
    _FLAG_MASK,
    SupervisedClient,
    op_name,
    spawn_worker,
)

__all__ = [
    "ArenaRegion",
    "ArenaSlab",
    "SidecarPool",
    "connect_pool",
    "current_pool",
    "shutdown_pool",
    "stats_section",
    "health_section",
    "hedge_section",
    "open_slab_count",
    "arena_leak_report",
]

_MIN_REGION_BYTES = 4096  # smallest buddy block (header included)


def _env_int(name: str, default: int = ...) -> int:
    # typed registry accessor (utils/knobs.py): malformed values warn
    # and keep the declared default, and the per-knob minimum clamps
    from .utils import knobs

    return knobs.get_int(name, default=default)


def _pow2_ceil(n: int) -> int:
    return 1 << max(int(n) - 1, 1).bit_length()


# ---------------------------------------------------------------------------
# the slab-arena allocator (the per-request data plane)
# ---------------------------------------------------------------------------


class ArenaRegion:
    """One leased region of the slab: a power-of-two block whose first
    32 bytes are the region header (sidecar.REGION_HDR) and the rest is
    payload space. ``write()`` bumps the generation and rewrites header
    + payload in one go — the unit a retry attempt replays. Use as a
    context manager or ``release()`` explicitly; the slab counts every
    un-released lease at teardown as a leak."""

    __slots__ = (
        "slab", "offset", "capacity", "request_id", "generation",
        "payload_len", "_released", "_snapshot",
    )

    def __init__(self, slab: "ArenaSlab", offset: int, capacity: int,
                 request_id: int):
        self.slab = slab
        self.offset = offset
        self.capacity = capacity
        self.request_id = request_id
        self.generation = 0
        self.payload_len = 0
        self._released = False
        self._snapshot: Optional[bytes] = None
        self._write_header()

    def _write_header(self) -> None:
        self.slab._mm[self.offset : self.offset + REGION_HDR_LEN] = REGION_HDR.pack(
            REGION_MAGIC, self.generation, self.request_id,
            self.capacity, self.payload_len,
        )

    def write(self, data: bytes) -> None:
        """Place ``data`` in the region and stamp a fresh generation.
        Oversized payloads raise retryably with the needed size so
        retry-with-split engages, never a truncated write."""
        n = len(data)
        if n > self.capacity:
            from .utils.errors import RetryableError

            raise RetryableError(
                f"sidecar pool: RESOURCE_EXHAUSTED: region of "
                f"{self.capacity} bytes cannot hold a {n}-byte request "
                f"(need {n}) — split the batch or lease a larger region"
            )
        if self._released:
            raise ValueError("write to a released arena region")
        self.generation = (self.generation + 1) & 0xFFFFFFFF
        self.payload_len = n
        self._snapshot = bytes(data)
        start = self.offset + REGION_HDR_LEN
        self._write_header()
        self.slab._mm[start : start + n] = data

    def payload_bytes(self) -> bytes:
        start = self.offset + REGION_HDR_LEN
        return bytes(self.slab._mm[start : start + self.payload_len])

    def snapshot_bytes(self) -> bytes:
        """The request bytes as HANDED TO ``write()`` — never an mmap
        re-read. Request CRCs and retry replays must draw from here: a
        slow stale worker's slab write straddling a rewrite can tear
        the shared pages, and a checksum computed over a re-read would
        bless the torn bytes instead of catching them."""
        if self._snapshot is None:
            return self.payload_bytes()
        return self._snapshot

    def read(self, n: int) -> bytes:
        if n > self.capacity:
            raise ValueError(f"read of {n} bytes exceeds region capacity")
        start = self.offset + REGION_HDR_LEN
        return bytes(self.slab._mm[start : start + n])

    def release(self) -> None:
        if not self._released:
            self._released = True
            # scribble the in-slab header magic BEFORE the block goes
            # back to the free list: the worker re-validates the header
            # immediately before answering through the slab, and a
            # freed block coalesced into a larger re-lease keeps its
            # interior bytes — a stale-but-intact header there would
            # let a slow worker (whose client already gave up) pass
            # validation and clobber the new lease's payload
            try:
                REGION_HDR.pack_into(
                    self.slab._mm, self.offset,
                    0, self.generation, self.request_id, self.capacity, 0,
                )
            except (ValueError, IndexError):
                pass  # slab already closed/munmapped
            self._snapshot = None
            self.slab._release(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()


class ArenaSlab:
    """memfd-backed slab carved by a buddy free-list into power-of-two
    regions. The allocator is the ONLY shared state on the slab data
    plane — leases are O(log size) under one short lock, and buddy
    coalescing on release keeps large leases possible after bursts of
    small ones."""

    _OPEN: Dict[int, "ArenaSlab"] = {}
    _OPEN_LOCK = threading.Lock()

    def __init__(self, size_bytes: Optional[int] = None):
        if size_bytes is None:
            # default + minimum clamp both live in the registry row
            size_bytes = _env_int("SRJTORCH_ARENA_SLAB_BYTES")
        size = _pow2_ceil(max(int(size_bytes), _MIN_REGION_BYTES))
        self.size = size
        self.fd = os.memfd_create("srjtorch-pool-slab")
        os.ftruncate(self.fd, size)
        self._mm = mmap.mmap(self.fd, size)
        self._lock = threading.Lock()
        self._max_k = size.bit_length() - 1
        self._min_k = _MIN_REGION_BYTES.bit_length() - 1
        self._free: Dict[int, set] = {k: set() for k in range(self._min_k, self._max_k + 1)}
        self._free[self._max_k].add(0)
        self._leased: Dict[int, int] = {}  # offset -> block log2
        self._next_rid = 1
        self._closed = False
        with ArenaSlab._OPEN_LOCK:
            ArenaSlab._OPEN[id(self)] = self
        self._set_gauges()

    # -- accounting ----------------------------------------------------------

    def _reg(self):
        from .utils import metrics

        return metrics.registry()

    def _set_gauges(self) -> None:
        # the gauges are process-global: aggregate over every OPEN slab
        # so two live slabs (two pools, or a standalone slab beside a
        # pool's) don't clobber each other, and closing one slab
        # doesn't zero out the bytes another still has mapped
        with ArenaSlab._OPEN_LOCK:
            slabs = list(ArenaSlab._OPEN.values())
        reg = self._reg()
        reg.gauge("sidecar.pool.slab_bytes").set(sum(s.size for s in slabs))
        reg.gauge("sidecar.pool.slab_regions").set(
            sum(s.outstanding for s in slabs)
        )

    @property
    def outstanding(self) -> int:
        with self._lock:
            return len(self._leased)

    def leased_bytes(self) -> int:
        with self._lock:
            return sum(1 << k for k in self._leased.values())

    # -- lease / release -----------------------------------------------------

    def lease(self, nbytes: int) -> ArenaRegion:
        """Lease a region able to hold an ``nbytes`` payload (plus the
        32-byte header), rounded up to the block's power-of-two size
        class. Exhaustion — or a payload larger than the whole slab —
        raises retryably with a RESOURCE_EXHAUSTED marker so the retry
        orchestrator's split path engages."""
        from .utils.errors import RetryableError

        need = int(nbytes) + REGION_HDR_LEN
        k = max(need.bit_length() - 1, self._min_k)
        if (1 << k) < need:
            k += 1
        with self._lock:
            if self._closed:
                raise ValueError("lease on a closed arena slab")
            if k > self._max_k:
                raise RetryableError(
                    f"sidecar pool: RESOURCE_EXHAUSTED: a {nbytes}-byte "
                    f"request (need {need}) exceeds the {self.size}-byte "
                    "arena slab — split the batch or raise "
                    "SRJTORCH_ARENA_SLAB_BYTES"
                )
            off = self._alloc_locked(k)
            if off is None:
                raise RetryableError(
                    f"sidecar pool: RESOURCE_EXHAUSTED: arena slab "
                    f"exhausted ({nbytes} bytes requested, "
                    f"{len(self._leased)} regions leased) — release "
                    "regions, split the batch, or raise "
                    "SRJTORCH_ARENA_SLAB_BYTES"
                )
            self._leased[off] = k
            rid = self._next_rid
            self._next_rid += 1
        reg = self._reg()
        reg.counter("sidecar.pool.region_leases").inc()
        # delta update, NOT _set_gauges(): re-aggregating every open
        # slab (global lock + per-slab locks) on the per-op hot path
        # would re-serialize exactly the traffic the slab exists to
        # parallelize; full recomputes happen only at slab open/close
        reg.gauge("sidecar.pool.slab_regions").inc()
        return ArenaRegion(self, off, (1 << k) - REGION_HDR_LEN, rid)

    def _alloc_locked(self, k: int) -> Optional[int]:
        j = k
        while j <= self._max_k and not self._free[j]:
            j += 1
        if j > self._max_k:
            return None
        off = self._free[j].pop()
        while j > k:  # buddy split down to the requested class
            j -= 1
            self._free[j].add(off + (1 << j))
        return off

    def _release(self, region: ArenaRegion) -> None:
        with self._lock:
            if self._closed:
                return
            k = self._leased.pop(region.offset, None)
            if k is None:
                return
            off = region.offset
            while k < self._max_k:  # buddy coalescing
                buddy = off ^ (1 << k)
                if buddy not in self._free[k]:
                    break
                self._free[k].discard(buddy)
                off = min(off, buddy)
                k += 1
            self._free[k].add(off)
        reg = self._reg()
        reg.counter("sidecar.pool.region_releases").inc()
        reg.gauge("sidecar.pool.slab_regions").inc(-1)  # hot path: delta, see lease()

    # -- teardown ------------------------------------------------------------

    def close(self) -> int:
        """munmap + close the memfd. Returns the number of regions that
        were still leased (force-released, counted
        ``sidecar.pool.region_leaks``) — zero in a leak-free run, the
        invariant the test suite asserts."""
        with self._lock:
            if self._closed:
                return 0
            self._closed = True
            leaks = len(self._leased)
            self._leased.clear()
        if leaks:
            self._reg().counter("sidecar.pool.region_leaks").inc(leaks)
            from .utils import metrics

            metrics.event("sidecar.pool.region_leak", count=leaks)
        self._mm.close()
        os.close(self.fd)
        with ArenaSlab._OPEN_LOCK:
            ArenaSlab._OPEN.pop(id(self), None)
        self._set_gauges()
        return leaks


def open_slab_count() -> int:
    """Open (un-closed) slabs in this process — the leak tripwire the
    test harness checks at session end."""
    with ArenaSlab._OPEN_LOCK:
        return len(ArenaSlab._OPEN)


def arena_leak_report() -> List[str]:
    """Human-readable description of every open slab (empty when the
    teardown discipline held)."""
    with ArenaSlab._OPEN_LOCK:
        slabs = list(ArenaSlab._OPEN.values())
    return [
        f"slab of {s.size} bytes with {s.outstanding} leased regions"
        for s in slabs
    ]


# ---------------------------------------------------------------------------
# the supervised pool
# ---------------------------------------------------------------------------


class _Worker:
    """One supervised pool slot: the worker process, its socket, its
    client, and its liveness. The slot id (``wid``) is stable across
    respawns — metrics and routing name the SLOT, not the process.
    ``io_lock`` serializes frames on the worker's single supervised
    connection (concurrent callers of ``SidecarPool.call`` may route to
    the same slot); ``arena_conn`` remembers WHICH socket carried the
    last SET_ARENA — worker-side arena state is per-connection, so any
    reconnect invalidates it and the pool must replay.

    Tail-tolerance state: ``quarantined`` takes the slot out
    of preferred routing (the worker stays ALIVE — gray, not dead);
    ``strikes`` is the detector's net slow-sample count and
    ``clean_probes`` the reinstatement run; ``probe_thread`` is the
    background prober shutdown joins, like ``respawn_thread``."""

    __slots__ = (
        "wid", "proc", "sock_path", "client", "alive", "spawns",
        "io_lock", "arena_conn", "respawn_thread",
        "quarantined", "strikes", "clean_probes", "probe_thread",
    )

    def __init__(self, wid: int):
        self.wid = wid
        self.proc = None
        self.sock_path: Optional[str] = None
        self.client: Optional[SupervisedClient] = None
        self.alive = False
        self.spawns = 0
        self.io_lock = threading.Lock()
        self.arena_conn = None
        self.respawn_thread: Optional[threading.Thread] = None
        self.quarantined = False
        self.strikes = 0
        self.clean_probes = 0
        self.probe_thread: Optional[threading.Thread] = None


class SidecarPool:
    """Supervised pool of sidecar workers with health-checked routing,
    automatic respawn, slab re-hydration, and pool-scoped breaker
    accounting. ``call()`` is the public entry — same contract as
    ``SupervisedClient.call`` (results keep flowing: device path first,
    retry across workers, host engine as the floor), with worker death
    downgraded from "permanent degrade" to "one failover". The arena
    data plane is ``lease()`` + ``call(op, region=...)`` (or the
    one-shot ``call_arena``): per-request regions, so concurrent
    arena-resident ops on distinct workers genuinely overlap."""

    def __init__(
        self,
        size: Optional[int] = None,
        deadline_s: Optional[float] = None,
        heartbeat_s: Optional[float] = None,
        env: Optional[dict] = None,
        startup_timeout_s: float = 60.0,
        spawn_fn=None,
        slab_bytes: Optional[int] = None,
        device: str = "cuda",
    ):
        if size is None:
            size = _env_int("SRJTORCH_SIDECAR_POOL_SIZE")
        if size < 1:
            raise ValueError(f"pool size must be >= 1, got {size}")
        self.size = int(size)
        self._deadline_s = deadline_s
        self._heartbeat_s = heartbeat_s
        self._env = dict(env) if env else None
        self._startup_timeout_s = float(startup_timeout_s)
        # the workers' device: the card unless the caller asks for the CPU
        self.device = device
        self._spawn_fn = (
            functools.partial(spawn_worker, device=device) if spawn_fn is None else spawn_fn
        )
        self._respawn_max = _env_int("SRJTORCH_POOL_RESPAWN_MAX")
        from .utils import knobs

        self._respawn_delay_s = knobs.get_float("SRJTORCH_POOL_RESPAWN_DELAY_S")
        self._slab_bytes = slab_bytes
        self._lock = threading.RLock()
        # wait_healthy and the quarantine/respawn transitions meet on
        # this condition (notify-backed — no sleep-polling)
        self._health = threading.Condition(self._lock)
        self._rr = 0
        self._closed = False
        # health scorer state: per-(worker, op-class) latency EWMA +
        # jitter, bounded (utils/metrics.KeyedEwma) — the pool-wide
        # baseline is the always-on sidecar.op_lat_us.<OP> histograms
        from .utils import metrics as _metrics

        self._ewma = _metrics.KeyedEwma(alpha=0.3, max_keys=512)
        # srjt-race layer 2: the health/quarantine state is dynamically
        # tracked when SRJTORCH_RACE=1 — per-worker records
        # (alive/quarantined/strikes/clean_probes writes), the scorer's
        # EWMA map, and the hedge-budget counter all feed the
        # vector-clock detector; disarmed, track() is one boolean read
        from .analysis.lockdep import track as _race_track

        self._ewma._entries = _race_track(
            self._ewma._entries, "pool.ewma_entries"
        )
        _race_track(
            self._reg().counter("sidecar.pool.hedges_launched"),
            "pool.hedge_budget",
        )
        # hedge-budget reservations are check-AND-increment under one
        # lock: two dispatch slots racing the same last budget slot
        # must not both launch (the hedge budget is a hard ceiling, not
        # a soft target)
        self._hedge_lock = threading.Lock()
        # the slab-arena data plane: ONE memfd shared by every worker
        # (they all map the same pages), surviving any of them; regions
        # are leased per request, so the only pool-wide arena state is
        # the allocator
        self._slab: Optional[ArenaSlab] = None
        self._workers = [
            _race_track(_Worker(i), f"pool.w{i}") for i in range(self.size)
        ]
        # the slots boot in parallel (a worker's start-up is its interpreter,
        # torch and the device context: seconds each)
        errors: List[BaseException] = []

        def boot(w: _Worker) -> None:
            try:
                self._spawn_locked(w)
            except BaseException as e:  # srjt-lint: allow-broad-except(thread-exit funnel: the constructor re-raises errors[0] after joining every boot thread)
                errors.append(e)

        threads = [threading.Thread(target=boot, args=(w,), daemon=True,
                                    name=f"srjtorch-pool-boot-w{w.wid}")
                   for w in self._workers[1:]]
        for t in threads:
            t.start()
        boot(self._workers[0])
        for t in threads:
            t.join()
        if errors:
            self.shutdown()
            raise errors[0]
        self._set_gauges()

    # -- lifecycle -----------------------------------------------------------

    def _reg(self):
        from .utils import metrics

        return metrics.registry()

    def _set_gauges(self) -> None:
        reg = self._reg()
        reg.gauge("sidecar.pool.size").set(self.size)
        reg.gauge("sidecar.pool.live").set(self.live_count())
        for w in self._workers:
            reg.gauge(f"sidecar.pool.worker.w{w.wid}.alive").set(
                1 if w.alive else 0
            )

    def _worker_env(self, w: _Worker) -> dict:
        """Spawn env for slot ``w``: the caller's overrides plus the
        slot's fault-injection tag — per-worker rule keys
        like ``sidecar.worker.<OP>@w1`` resolve only inside the worker
        whose tag matches, so a chaos profile can gray exactly one
        worker of a real pool."""
        env = dict(self._env) if self._env else {}
        env.setdefault("SRJTORCH_FAULTINJ_WORKER", f"w{w.wid}")
        return env

    def _spawn_locked(self, w: _Worker) -> None:
        """Initial spawn of slot ``w`` (no arena exists yet; respawns
        go through ``_respawn``, which also re-hydrates state)."""
        proc, sock = self._spawn_fn(
            startup_timeout_s=self._startup_timeout_s, env=self._worker_env(w)
        )
        w.proc, w.sock_path = proc, sock
        w.client = SupervisedClient(
            sock, deadline_s=self._deadline_s, heartbeat_s=self._heartbeat_s
        )
        w.spawns += 1
        w.alive = True

    def shutdown(self) -> None:
        """Terminate every worker and release the slab (every region
        munmapped; leaked leases counted). Idempotent. Joins in-flight
        respawn threads FIRST (bounded by one spawn attempt): a daemon
        respawner killed at interpreter exit while inside spawn_fn
        orphans its half-born worker — the child would outlive the
        pool, holding the chip and (if stdio is a pipe) the parent's
        readers. Once ``_closed`` is set the respawner reaps whatever
        it spawned and returns, so after the join every live proc is in
        a slot where the sweep below can reach it."""
        with self._lock:
            self._closed = True
            workers = list(self._workers)
            # wake parked quarantine probers (and wait_healthy callers)
            # so the joins below never ride out a full probe interval
            self._health.notify_all()
        join_s = self._startup_timeout_s + self._respawn_delay_s + 10
        for w in workers:
            t = w.respawn_thread
            if t is not None and t.is_alive():
                t.join(timeout=join_s)
        for w in workers:
            # quarantine probers poll _closed every interval and their
            # probe pings run under a short deadline scope: bounded join
            t = w.probe_thread
            if t is not None and t.is_alive():
                t.join(timeout=30)
        for w in workers:
            if w.client is not None:
                w.client.close()
            if w.proc is not None and w.proc.poll() is None:
                w.proc.terminate()
        for w in workers:
            if w.proc is not None:
                try:
                    w.proc.wait(timeout=10)
                except Exception:  # srjt-lint: allow-broad-except(best-effort shutdown: a worker that will not die in 10s gets SIGKILLed; teardown must reap every slot regardless)
                    w.proc.kill()
            if w.sock_path:
                try:
                    os.unlink(w.sock_path)
                except OSError:
                    pass
            w.alive = False
        self._close_slab()
        self._set_gauges()

    def _close_slab(self) -> None:
        # detach AND unregister in one critical section: unregistering
        # after dropping the lock races a concurrent ensure_slab()
        # registering its fresh slab — that registration would be the
        # one deleted, leaving live pinned pages invisible to memgov
        with self._lock:
            slab, self._slab = self._slab, None
            if slab is not None:
                from . import memgov

                memgov.catalog().unregister("sidecar.pool.arena")
        if slab is not None:
            slab.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()

    # -- routing -------------------------------------------------------------

    def live_count(self) -> int:
        return sum(1 for w in self._workers if w.alive)

    def routable_count(self) -> int:
        """Live AND unquarantined workers — the set fresh traffic
        prefers. The serving layer's quarantine-aware routing consults
        this (a pool whose every live worker is gray sheds
        non-host-eligible work instead of queueing onto stragglers)."""
        return sum(1 for w in self._workers if w.alive and not w.quarantined)

    def _pick(self, exclude: Optional[_Worker] = None,
              allow_quarantined: bool = True) -> Optional[_Worker]:
        """Round-robin over live workers, PREFERRING the unquarantined: a gray worker only takes fresh traffic when every
        peer is dead or equally gray — degraded routing beats a dark
        pool, and the fallback is counted so operators can see it.
        ``exclude`` lets hedged dispatch land the duplicate on a
        DIFFERENT worker, and ``allow_quarantined=False`` disables the
        gray fallback entirely (a hedge duplicated onto the known
        straggler would be pure waste); None when no eligible worker
        exists."""
        with self._lock:
            n = len(self._workers)
            fallback = None
            for i in range(n):
                w = self._workers[(self._rr + i) % n]
                if not w.alive or w is exclude:
                    continue
                if w.quarantined:
                    if allow_quarantined and fallback is None:
                        fallback = (w, i)
                    continue
                self._rr = (self._rr + i + 1) % n
                return w
            if fallback is not None:
                w, i = fallback
                self._rr = (self._rr + i + 1) % n
                self._reg().counter("sidecar.pool.quarantine_fallbacks").inc()
                return w
        return None

    def _on_worker_failure(self, w: _Worker, exc: BaseException) -> None:
        """A request died with its worker: mark the slot dead ONCE,
        count the failover (when living peers remain to fail over TO),
        and hand the slot to the background respawner."""
        from .utils import metrics

        reg = self._reg()
        with self._lock:
            if not w.alive or self._closed:
                return
            w.alive = False
            if w.quarantined:
                # quarantined → dead: the slot leaves the gray state
                # (the replacement process starts with a clean record);
                # the probe thread sees alive=False and exits
                w.quarantined = False
                reg.gauge(f"sidecar.pool.worker.w{w.wid}.quarantined").set(0)
                self._set_quarantined_gauge_locked()
            w.strikes = 0
            w.clean_probes = 0
            if w.client is not None:
                w.client.close()
            reg.counter("sidecar.pool.worker_deaths").inc()
            reg.gauge(f"sidecar.pool.worker.w{w.wid}.alive").set(0)
            live = self.live_count()
            reg.gauge("sidecar.pool.live").set(live)
            if live > 0:
                reg.counter("sidecar.pool.failovers").inc()
            self._health.notify_all()
            metrics.event(
                "sidecar.pool.worker_death",
                wid=w.wid,
                live=live,
                cls=type(exc).__name__,
            )
            t = threading.Thread(
                target=self._respawn, args=(w,), daemon=True,
                name=f"srjtorch-pool-respawn-w{w.wid}",
            )
            w.respawn_thread = t  # shutdown joins this before reaping
            t.start()

    def _respawn(self, w: _Worker) -> None:
        """Background supervisor for one dead slot: reap the corpse,
        spawn a replacement (bounded attempts), re-hydrate state. The
        SPAWN happens outside the pool lock — routing to the surviving
        workers must never queue behind a replacement booting torch."""
        from .utils import metrics

        if w.proc is not None:
            sidecar._reap_worker(w.proc)
        if w.sock_path:
            try:
                os.unlink(w.sock_path)
            except OSError:
                pass
        for attempt in range(self._respawn_max):
            # liveness check under the pool lock: a
            # shutdown() racing this read must either be seen here or
            # see this respawner's subsequent spawn via the in-lock
            # re-checks below — a torn bare read could do neither
            with self._lock:
                if self._closed or w.alive:
                    return
            try:
                proc, sock = self._spawn_fn(
                    startup_timeout_s=self._startup_timeout_s,
                    env=self._worker_env(w),
                )
            except BaseException as e:  # srjt-lint: allow-broad-except(detached respawn supervisor: ANY spawn failure — incl. interpreter-teardown errors — is one counted attempt; escaping would kill the supervisor thread and strand the slot forever)
                metrics.event(
                    "sidecar.pool.respawn_failed",
                    wid=w.wid, attempt=attempt, err=str(e)[:200],
                )
                # detached respawn supervisor thread: owns no query
                # budget; bounded by SRJTORCH_POOL_RESPAWN_MAX attempts and
                # joined by shutdown
                time.sleep(self._respawn_delay_s)
                continue
            with self._lock:
                if self._closed:
                    sidecar._reap_worker(proc)
                    return
                w.proc, w.sock_path = proc, sock
                w.client = SupervisedClient(
                    sock,
                    deadline_s=self._deadline_s,
                    heartbeat_s=self._heartbeat_s,
                )
                w.spawns += 1
                has_arena = self._slab is not None
            # state re-hydration OUTSIDE the pool lock (a wedged
            # replacement answering SET_ARENA slowly must not stall
            # routing to the survivors); nobody routes to this slot
            # until alive flips below, so its socket is private here.
            # The slab memfd is the SAME pages every other worker maps,
            # region headers included — the slab map IS the state.
            try:
                if has_arena:
                    self._send_arena(w)
                    self._reg().counter("sidecar.pool.rehydrations").inc()
                    metrics.event("sidecar.pool.rehydrate", wid=w.wid)
            except BaseException as e:  # srjt-lint: allow-broad-except(respawn re-hydration: a half-born worker that cannot take the arena is reaped and the attempt counted; escaping would strand the slot with a live unreachable child)
                metrics.event(
                    "sidecar.pool.respawn_failed",
                    wid=w.wid, attempt=attempt, err=str(e)[:200],
                )
                sidecar._reap_worker(proc)
                continue
            with self._lock:
                if self._closed:
                    sidecar._reap_worker(proc)
                    return
                w.alive = True
                self._reg().counter("sidecar.pool.respawns").inc()
                self._set_gauges()
                self._health.notify_all()
            metrics.event("sidecar.pool.respawn", wid=w.wid)
            return

    def _healthy_locked(self) -> bool:
        return not self._closed and all(
            w.alive and not w.quarantined for w in self._workers
        )

    def wait_healthy(self, timeout_s: float = 60.0) -> bool:
        """Block until every slot is live AND unquarantined (tests /
        operators). NOTIFY-backed: respawn completions,
        reinstatements, and deaths all signal the health condition, so
        the wait wakes the instant the pool turns healthy instead of
        on a poll tick — and it is quarantine-AWARE: a pool whose only
        live worker is gray is not healthy."""
        end = time.monotonic() + timeout_s
        with self._health:
            while not self._healthy_locked():
                remaining = end - time.monotonic()
                if remaining <= 0:
                    return self._healthy_locked()
                self._health.wait(remaining)
            return True

    # -- the health scorer + quarantine (gray-failure defense) ------

    def _set_quarantined_gauge_locked(self) -> None:
        self._reg().gauge("sidecar.pool.quarantined").set(
            sum(1 for w in self._workers if w.quarantined)
        )

    def _note_latency(self, w: _Worker, op: int, elapsed_s: float,
                      timed_out: bool = False) -> None:
        """One routed exchange's latency verdict: fold the sample into
        the worker's per-op-class EWMA/jitter and run the gray-failure
        detector — a sample slower than ``SRJTORCH_QUARANTINE_SLOW_FACTOR``
        × the pool-wide op-class p50 (or any request TIMEOUT, the
        unambiguous slow signal) is a strike; a clean sample pays one
        back. ``SRJTORCH_QUARANTINE_STRIKES`` net strikes quarantine the
        slot. Cold op classes (fewer than
        ``SRJTORCH_QUARANTINE_MIN_SAMPLES`` pool-wide samples) yield no
        verdict either way: a first compile is slow, not gray."""
        from .utils import knobs

        if not knobs.get_bool("SRJTORCH_QUARANTINE_ENABLED"):
            return
        name = op_name(op)
        self._ewma.update(f"w{w.wid}.{name}", elapsed_s)
        slow = timed_out
        if not slow:
            h = self._reg().histogram(f"sidecar.op_lat_us.{name}")
            if h.count < knobs.get_int("SRJTORCH_QUARANTINE_MIN_SAMPLES"):
                return
            p50_us = h.quantile(0.5)
            if p50_us is None:
                return
            factor = knobs.get_float("SRJTORCH_QUARANTINE_SLOW_FACTOR")
            slow = elapsed_s > max(p50_us / 1e6, 1e-5) * factor
        cause = None
        strikes = 0
        with self._lock:
            if self._closed or not w.alive:
                return
            if not slow:
                w.strikes = max(w.strikes - 1, 0)
                return
            w.strikes += 1
            if (not w.quarantined
                    and w.strikes >= knobs.get_int("SRJTORCH_QUARANTINE_STRIKES")):
                cause = "timeout" if timed_out else "slow"
                strikes = w.strikes
                self._quarantine_locked(w, cause)
        if cause is not None:
            # event-log file I/O strictly OUTSIDE the routing lock: a
            # slow log write during a quarantine
            # transition must not stall _pick/wait_healthy
            from .utils import metrics

            metrics.event(
                "sidecar.pool.quarantine", wid=w.wid, cause=cause,
                strikes=strikes,
            )

    def _quarantine_locked(self, w: _Worker, cause: str) -> None:
        """Move a live-but-gray slot out of preferred routing and hand
        it to the background prober (caller holds self._lock; caller
        also owns emitting the quarantine EVENT after the lock drops —
        counters are in-lock-safe memory, file I/O is not). The worker
        process is NOT touched — in-flight requests drain on their own
        deadlines, and reinstatement is cheap."""
        w.quarantined = True
        w.clean_probes = 0
        reg = self._reg()
        reg.counter("sidecar.pool.quarantines").inc()
        reg.gauge(f"sidecar.pool.worker.w{w.wid}.quarantined").set(1)
        self._set_quarantined_gauge_locked()
        t = threading.Thread(
            target=self._probe_quarantined, args=(w,), daemon=True,
            name=f"srjtorch-pool-probe-w{w.wid}",
        )
        w.probe_thread = t  # shutdown joins this, like the respawner
        t.start()
        self._health.notify_all()

    def _probe_quarantined(self, w: _Worker) -> None:
        """Background prober for one quarantined slot: a PING every
        ``SRJTORCH_QUARANTINE_PROBE_INTERVAL_S`` under a short deadline
        scope (utils/deadline.py — the probe can never hang on the
        wedge it is probing). A round-trip within
        ``SRJTORCH_QUARANTINE_PROBE_SLOW_S`` is CLEAN; anything else —
        slow answer, expired probe budget, or the io_lock still held
        by a wedged data op — resets the run.
        ``SRJTORCH_QUARANTINE_PROBES`` consecutive clean probes reinstate
        the slot; a dead transport hands it to the failover/respawn
        path instead (gray → dead is a real transition)."""
        from .utils import deadline as deadline_mod, knobs
        from .utils.errors import RetryableError

        reg = self._reg()
        while True:
            interval = knobs.get_float("SRJTORCH_QUARANTINE_PROBE_INTERVAL_S")
            # detached prober cadence: the wait rides the health
            # condition so shutdown/death/reinstatement wake it
            # immediately instead of stranding a long interval — but a
            # spurious wakeup (any peer's health event notifies too)
            # re-waits the REMAINING interval, so probe spacing honors
            # the knob even under pool churn; each probe itself runs
            # under its own deadline scope below
            wake_at = time.monotonic() + interval
            with self._health:
                while True:
                    if self._closed or not w.alive or not w.quarantined:
                        return
                    left = wake_at - time.monotonic()
                    if left <= 0:
                        break
                    self._health.wait(left)
                client = w.client
            slow_s = knobs.get_float("SRJTORCH_QUARANTINE_PROBE_SLOW_S")
            probe_budget = max(slow_s * 4, 1.0)
            ok = False
            dead_exc = None
            if w.io_lock.acquire(timeout=probe_budget):
                try:
                    t0 = time.monotonic()
                    try:
                        with deadline_mod.scope(probe_budget):
                            client.ping()
                        ok = (time.monotonic() - t0) <= slow_s
                    except RetryableError as e:
                        if self._worker_is_dead(w, e):
                            dead_exc = e
                    except Exception:  # srjt-lint: allow-broad-except(probe outcome is binary — an expired probe budget (DeadlineExceeded) or any semantic error is simply a dirty probe; the prober must outlive its subject)
                        pass
                finally:
                    w.io_lock.release()
            reg.counter("sidecar.pool.quarantine_probes").inc()
            if dead_exc is not None:
                self._on_worker_failure(w, dead_exc)
                return
            reinstated = False
            with self._lock:
                if self._closed or not w.alive or not w.quarantined:
                    return
                if not ok:
                    w.clean_probes = 0
                    continue
                w.clean_probes += 1
                if w.clean_probes >= knobs.get_int("SRJTORCH_QUARANTINE_PROBES"):
                    self._reinstate_locked(w)
                    reinstated = True
            if reinstated:
                from .utils import metrics

                # event file I/O outside the routing lock, as above
                metrics.event("sidecar.pool.reinstate", wid=w.wid)
                return

    def _reinstate_locked(self, w: _Worker) -> None:
        """K clean probes: the slot rejoins preferred routing with a
        clean record (caller holds self._lock and owns emitting the
        reinstate EVENT after the lock drops)."""
        w.quarantined = False
        w.strikes = 0
        w.clean_probes = 0
        reg = self._reg()
        reg.counter("sidecar.pool.reinstatements").inc()
        reg.gauge(f"sidecar.pool.worker.w{w.wid}.quarantined").set(0)
        self._set_quarantined_gauge_locked()
        self._health.notify_all()

    # -- the data path -------------------------------------------------------

    def _attempt(
        self,
        op: int,
        payload: bytes,
        region: Optional[ArenaRegion],
        region_req: Optional[bytes] = None,
    ):
        """One routed — and possibly HEDGED — exchange: the
        unit the retry orchestrator re-runs. When the op class is warm
        and hedging is armed, the primary leg runs with a hedge timer:
        past the op-class p95 a duplicate launches on a different
        healthy worker and the first valid response wins. Cold classes,
        single-worker pools, pressure, and budget exhaustion all fall
        back to the plain inline attempt."""
        from .utils.errors import RetryableError

        w = self._pick()
        if w is None:
            raise RetryableError(
                "sidecar pool: UNAVAILABLE: no live workers "
                f"(size={self.size}; respawn in progress or exhausted)"
            )
        delay_s = self._hedge_delay_s(op, w)
        if delay_s is None:
            return self._attempt_on(w, op, payload, region, region_req)
        return self._race(w, delay_s, op, payload, region, region_req)

    def _attempt_on(
        self,
        w: _Worker,
        op: int,
        payload: bytes,
        region: Optional[ArenaRegion],
        region_req: Optional[bytes] = None,
    ):
        """One exchange on a SPECIFIC worker. Worker death re-raises
        retryably AFTER marking the slot dead, so the next attempt
        routes around the corpse: that re-route IS the failover.
        Region requests REWRITE the request bytes (``region_req``,
        snapshotted by ``call``) into the leased region first, under a
        fresh generation: the worker answers into the same region, so
        a prior attempt's (possibly partial) response must never be
        what the retry re-sends — and a worker still holding the old
        generation gets a retryable desync, not stale bytes. Only the
        target worker's ``io_lock`` serializes: two region ops on two
        workers genuinely overlap (the whole point of the slab). Every
        exchange feeds the health scorer: successes and timeouts are
        latency samples (a timeout is the strongest), dead transports
        are the failover path's business. The sample clock starts AFTER
        the io_lock is acquired — the scorer judges the worker's
        SERVICE time, not time spent queued behind a peer caller on
        the same slot (contended routing must never quarantine a
        healthy worker).

        each attempt is one ``pool.request``
        span annotated with the ROUTING DECISION — worker id and its
        quarantine state at pick time — so a failover reads as two
        sibling attempts under the same ``pool.call`` span, the second
        on a different worker."""
        from .utils import tracing

        with tracing.span(
            "pool.request", op=op_name(op), wid=w.wid,
            quarantined=w.quarantined,
        ):
            return self._attempt_on_impl(w, op, payload, region,
                                           region_req)

    def _attempt_on_impl(
        self,
        w: _Worker,
        op: int,
        payload: bytes,
        region: Optional[ArenaRegion],
        region_req: Optional[bytes] = None,
    ):
        from .utils.errors import DataCorruption, RetryableError

        t0 = time.monotonic()
        try:
            with w.io_lock:
                t0 = time.monotonic()
                if region is None:
                    resp = w.client.request(op, payload)
                else:
                    # worker-side arena state is per-CONNECTION: replay
                    # SET_ARENA if the client reconnected since the last
                    # upload (timeout redial, desync close, respawn)
                    self._ensure_arena(w)
                    region.write(region_req)
                    resp = w.client.request(op, b"", region=region)
        except DataCorruption:
            # a corrupted FRAME is not a dead WORKER: the transport
            # round-tripped, the payload rotted. Retry re-sends; the
            # worker keeps its slot.
            self._note_latency(w, op, time.monotonic() - t0)
            raise
        except RetryableError as e:
            if self._worker_is_dead(w, e):
                self._on_worker_failure(w, e)
            else:
                # every exchange the worker ANSWERED is a latency
                # observation, whatever the classification: a lost
                # hedge race's loser surfaces as a region desync (the
                # winner's caller released the lease), and before this
                # was scored a gray worker whose stragglers kept losing
                # races never accumulated strikes — the defense hid the
                # evidence. Timeouts stay the unambiguous strong signal.
                self._note_latency(
                    w, op, time.monotonic() - t0,
                    timed_out="DEADLINE_EXCEEDED" in str(e),
                )
            raise
        self._note_latency(w, op, time.monotonic() - t0)
        return resp

    # -- hedged dispatch (tail-latency defense) ---------------------

    def _hedge_pressure_cause(self) -> Optional[str]:
        """Hedging must never melt an overloaded pool: duplicates are
        withheld while the memory governor reports blocked admissions
        or within ``SRJTORCH_HEDGE_SHED_WINDOW_S`` of a serve-layer shed
        (the scheduler stamps ``serve.last_shed_s`` registry-direct)."""
        from . import memgov
        from .utils import knobs

        reg = self._reg()
        if memgov.is_enabled() and reg.value("memgov.queue_depth", 0) > 0:
            return "memgov_pressure"
        last_shed = reg.value("serve.last_shed_s", None)
        if (
            last_shed is not None
            and time.monotonic() - last_shed
            < knobs.get_float("SRJTORCH_HEDGE_SHED_WINDOW_S")
        ):
            return "shed_pressure"
        return None

    def _hedge_budget_ok(self) -> bool:
        """Global hedge budget: duplicates stay ≤
        ``SRJTORCH_HEDGE_BUDGET_PCT`` percent of total pool calls."""
        from .utils import knobs

        reg = self._reg()
        pct = knobs.get_float("SRJTORCH_HEDGE_BUDGET_PCT")
        launched = reg.value("sidecar.pool.hedges_launched", 0)
        calls = reg.value("sidecar.pool.calls", 0)
        return (launched + 1) * 100.0 <= pct * max(calls, 1)

    def _hedge_try_reserve(self) -> bool:
        """Atomically claim one hedge-budget slot (check + increment of
        ``sidecar.pool.hedges_launched`` under one lock): concurrent
        races at the budget margin get exactly one launch, never two —
        the gate on hedge volume is a hard ceiling."""
        with self._hedge_lock:
            if not self._hedge_budget_ok():
                return False
            self._reg().counter("sidecar.pool.hedges_launched").inc()
            return True

    def _hedge_delay_s(self, op: int, primary: _Worker) -> Optional[float]:
        """The hedge trigger for this attempt, or None to dispatch
        plainly inline: hedging needs the knob armed, a SECOND healthy
        worker to land on, a warm op class (≥ ``SRJTORCH_HEDGE_MIN_SAMPLES``
        pool-wide samples), no pressure, and enough remaining budget
        for a second leg to matter. The delay itself is the op-class
        p95 floored at ``SRJTORCH_HEDGE_MIN_DELAY_S`` — only the slow tail
        pays for a duplicate."""
        from .utils import deadline as deadline_mod, knobs, metrics

        if not knobs.get_bool("SRJTORCH_HEDGE_ENABLED"):
            return None
        with self._lock:
            if not any(
                x.alive and not x.quarantined and x is not primary
                for x in self._workers
            ):
                return None
        reg = self._reg()
        h = reg.histogram(f"sidecar.op_lat_us.{op_name(op)}")
        if h.count < knobs.get_int("SRJTORCH_HEDGE_MIN_SAMPLES"):
            return None
        cause = self._hedge_pressure_cause()
        if cause is not None:
            reg.counter("sidecar.pool.hedges_suppressed").inc()
            metrics.event(
                "sidecar.pool.hedge_suppressed", cause=cause, op=op_name(op)
            )
            return None
        p95_us = h.quantile(0.95)
        p50_us = h.quantile(0.5)
        if p95_us is None or p50_us is None:
            return None
        # pollution guard: one gray worker's slow samples inflate the
        # op-class p95 toward ITS latency — exactly the regime hedging
        # exists for — so the trigger is additionally ceilinged at the
        # quarantine slow threshold (factor × p50, median-robust). A
        # healthy tight distribution keeps p95 ≈ p50 and the ceiling
        # inert; a poisoned tail gets a trigger the stragglers still
        # cross.
        ceiling = max(p50_us / 1e6, 1e-5) * knobs.get_float(
            "SRJTORCH_QUARANTINE_SLOW_FACTOR"
        )
        delay = max(
            min(p95_us / 1e6, ceiling),
            knobs.get_float("SRJTORCH_HEDGE_MIN_DELAY_S"),
        )
        d = deadline_mod.current()
        if d is not None and delay >= d.remaining():
            return None  # no time left for a second leg to help
        return delay

    def _race(
        self,
        primary: _Worker,
        delay_s: float,
        op: int,
        payload: bytes,
        region: Optional[ArenaRegion],
        region_req: Optional[bytes],
    ):
        """Hedged dispatch: run the primary leg on its own thread (the
        ambient deadline scope rides contextvars into it); if it
        outlives ``delay_s``, launch ONE duplicate on a different
        healthy worker. FIRST VALID RESPONSE WINS — a winner is
        recorded exactly once under the race lock, the loser's eventual
        response (or error) is discarded. EVERY raced leg of a REGION
        request leases its own PRIVATE region, released in that leg's
        finally — the caller's lease is never handed to a thread that
        may outlive the race, so a straggling loser can neither write
        a released lease nor collide with the winner (and its full
        round-trip still lands in the health scorer: the gray evidence
        this race exists to collect). Both-legs-fail re-raises the
        primary's error so retry classification is unchanged from the
        unhedged path."""
        import contextvars

        from .utils import deadline as deadline_mod, metrics
        from .utils.errors import RetryableError

        reg = self._reg()
        primary_region = None
        if region is not None:
            try:
                # match the CALLER's capacity, not the request length:
                # the worker answers into the leg's region, and a
                # caller that leased big for a big response must keep
                # that headroom on every raced leg
                primary_region = self.lease(region.capacity)
            except RetryableError:
                # slab too tight for a private racing lease: dispatch
                # plainly inline on the caller's region instead
                return self._attempt_on(primary, op, payload, region,
                                        region_req)
        st_lock = threading.Lock()
        done = threading.Event()
        outcome = {"winner": None, "errors": {}, "legs": 1, "completed": 0}

        def leg(w, leg_region, is_hedge):
            # each raced leg is its own span —
            # the two legs are SIBLINGS under the caller's pool.call
            # span (contextvars.copy_context carries the trace into the
            # leg threads), and the winner is annotated EXACTLY ONCE,
            # under the same race lock that settles the winner slot,
            # while its span is still open
            from .utils import tracing

            with tracing.span(
                "pool.hedge_leg", op=op_name(op), wid=w.wid,
                leg="hedge" if is_hedge else "primary",
            ) as leg_span:
                try:
                    r = self._attempt_on(w, op, payload, leg_region,
                                         region_req)
                except BaseException as e:  # srjt-lint: allow-broad-except(race leg: the error is stored for the settling thread to re-raise with full taxonomy; escaping would kill the leg thread and strand the race)
                    leg_span.annotate(error=type(e).__name__)
                    with st_lock:
                        outcome["errors"][is_hedge] = e
                        outcome["completed"] += 1
                        if (outcome["completed"] >= outcome["legs"]
                                and outcome["winner"] is None):
                            done.set()
                    return
                with st_lock:
                    outcome["completed"] += 1
                    if outcome["winner"] is None:
                        outcome["winner"] = (r, is_hedge)
                        leg_span.annotate(winner=True)
                    done.set()

        def primary_leg():
            try:
                leg(primary, primary_region, False)
            finally:
                if primary_region is not None:
                    primary_region.release()

        ctx = contextvars.copy_context()
        threading.Thread(
            target=ctx.run, args=(primary_leg,),
            daemon=True, name=f"srjtorch-pool-leg-w{primary.wid}",
        ).start()
        hedged = False
        if not done.wait(delay_s):
            # the duplicate must land on a HEALTHY peer — a hedge
            # routed onto a quarantined straggler is pure waste, so the
            # gray fallback is disabled for this pick
            w2 = self._pick(exclude=primary, allow_quarantined=False)
            hedge_region = None
            suppress_cause = None
            if w2 is None:
                suppress_cause = "no_peer"
            else:
                if region is not None:
                    try:
                        # hedges lease DISTINCT regions (caller-sized,
                        # as above): the duplicate must never write
                        # into the primary's lease
                        hedge_region = self.lease(region.capacity)
                    except RetryableError:
                        # slab exhausted: the hedge is a nicety, the
                        # primary leg is the request — suppress, don't
                        # fail the race
                        suppress_cause = "slab_exhausted"
                if suppress_cause is None and not self._hedge_try_reserve():
                    suppress_cause = "budget"
                    if hedge_region is not None:
                        hedge_region.release()
                        hedge_region = None
            if suppress_cause is not None:
                reg.counter("sidecar.pool.hedges_suppressed").inc()
                metrics.event(
                    "sidecar.pool.hedge_suppressed",
                    cause=suppress_cause, op=op_name(op),
                )
            else:
                with st_lock:
                    outcome["legs"] = 2
                    if outcome["winner"] is None and outcome["completed"]:
                        # the primary FAILED inside the launch window
                        # and settled a one-leg race: un-settle it —
                        # the hedge is now in play, and first valid
                        # response still wins (both-fail re-settles
                        # via the completed >= legs path)
                        done.clear()
                hedged = True
                metrics.event(
                    "sidecar.pool.hedge", op=op_name(op),
                    primary=primary.wid, hedge=w2.wid,
                    delay_ms=round(delay_s * 1e3, 3),
                )

                def hedge_leg(hr=hedge_region, w=w2):
                    try:
                        leg(w, hr, True)
                    finally:
                        if hr is not None:
                            hr.release()

                threading.Thread(
                    target=contextvars.copy_context().run,
                    args=(hedge_leg,), daemon=True,
                    name=f"srjtorch-pool-hedge-w{w2.wid}",
                ).start()
        while not done.wait(0.25):
            # both legs are bounded by their own (adaptive) socket
            # deadlines, so the event always settles; the check here
            # just surfaces a dying QUERY budget promptly
            deadline_mod.check(f"sidecar_pool_hedge_{op_name(op)}")
        with st_lock:
            winner = outcome["winner"]
            errors = dict(outcome["errors"])
            completed = outcome["completed"]
            legs = outcome["legs"]
        if winner is None:
            # every launched leg failed: re-raise the primary's error
            # (retry classification identical to the unhedged path)
            raise errors.get(False) or errors.get(True)
        resp, is_hedge = winner
        if hedged:
            if is_hedge:
                reg.counter("sidecar.pool.hedges_won").inc()
                metrics.event("sidecar.pool.hedge_won", op=op_name(op))
            if legs == 2:
                # the loser was either still in flight (cancelled: its
                # response will be discarded on arrival) or already
                # answered a duplicate that lost the winner slot —
                # either way exactly one completion reached the caller
                reg.counter("sidecar.pool.hedges_cancelled").inc()
        return resp

    @staticmethod
    def _worker_is_dead(w: _Worker, exc: BaseException) -> bool:
        """Transport faults and an exited process mean the WORKER is
        gone; a per-request deadline (DEADLINE_EXCEEDED) means it is
        slow — slow workers keep their slot (the breaker's deadline
        conflation stays a POOL-level verdict, not a slot eviction)."""
        if w.proc is not None and w.proc.poll() is not None:
            return True
        text = str(exc)
        return any(
            m in text
            for m in (
                "UNAVAILABLE",
                "Socket closed",
                "peer closed",
                "Connection refused",
                "Connection reset",
                "Broken pipe",
            )
        )

    def call(self, op: int, payload: bytes = b"",
             region: Optional[ArenaRegion] = None) -> bytes:
        """Run ``op`` on the pool under the retry orchestrator: routed
        to a live worker, failed over on worker death, degraded to the
        in-process host engine only when the device path truly cannot
        answer. Breaker discipline: the process-global
        breaker records a FAILURE only when the op failed with the
        WHOLE pool dark — one crashed worker among living peers is a
        failover, invisible to the breaker.

        Region contract: ``lease()`` a region, ``region.write()`` the
        request, pass ``region=``; the RESPONSE IS THE RETURN VALUE.
        (With hedging armed a raced attempt runs both legs on private
        leases, so the caller's region is NOT rewritten with the
        response — its post-call contents are unspecified; read the
        returned bytes, as ``call_arena`` does.) Within one call the
        pool snapshots the request up front and replays it (fresh
        generation) before every retry attempt — a dead worker's
        partial response can never be what the failover re-sends.

        one ``pool.call`` span covers the whole
        call — every routed attempt (``pool.request``), hedge legs
        (``pool.hedge_leg`` siblings), and a degrade to the host engine
        (annotated ``host_fallback``) — so "the failover retry is a
        child of the original op span" holds by construction."""
        from .utils import tracing

        with tracing.span("pool.call", op=op_name(op)):
            return self._call_impl(op, payload, region)

    def _call_impl(self, op: int, payload: bytes,
                     region: Optional[ArenaRegion]) -> bytes:
        from .utils import deadline as deadline_mod, metrics, retry
        from .utils.errors import DeadlineExceeded, DeviceError

        deadline_mod.check(f"sidecar_pool_op_{op}")
        # the hedge budget's denominator: every pool call, hedged or not
        self._reg().counter("sidecar.pool.calls").inc()
        region_req = None
        if region is not None:
            # snapshot the request NOW, from the bytes the caller handed
            # write() — NOT an mmap re-read, which a stale worker's
            # straddling slab write could tear: every attempt (and the
            # host fallback) replays these bytes; the region itself is
            # scratch the previous attempt's response may have clobbered
            region_req = region.snapshot_bytes()
        br = sidecar.breaker()
        if not br.allow():
            self._host_fallback_count(op, "breaker_open")
            return sidecar._dispatch(
                op, payload if region_req is None else region_req, "host-fallback"
            )
        try:
            resp = retry.call_with_retry(
                self._attempt, op, payload, region, region_req,
                op_name=f"sidecar_pool_op_{op}",
            )
        except DeadlineExceeded:
            # same deliberate conflation as SupervisedClient.call: a
            # pool that cannot answer inside the budget is unavailable
            # for breaker purposes — unless the user cancelled
            d = deadline_mod.current()
            if d is not None and d.cancelled() and not d.expired():
                br.abort_probe()
            else:
                br.record_failure(cause="deadline")
            raise
        except DeviceError as e:
            if self.live_count() == 0:
                # the WHOLE pool is dark: this is what the breaker
                # exists to remember
                br.record_failure(cause=type(e).__name__)
            self._host_fallback_count(op, type(e).__name__)
            return sidecar._dispatch(
                op, payload if region_req is None else region_req, "host-fallback"
            )
        except Exception:
            br.record_success()  # semantic error: transport healthy
            raise
        except BaseException:
            br.abort_probe()
            raise
        br.record_success()
        return resp

    def call_arena(self, op: int, payload: bytes) -> bytes:
        """One-shot arena-resident exchange: lease a region, place the
        payload, run ``call``, release. The composable path is
        ``lease()`` + ``region.write()`` + ``call(op, region=...)`` for
        callers that reuse a region across requests."""
        region = self.lease(len(payload))
        try:
            region.write(payload)
            return self.call(op, region=region)
        finally:
            region.release()

    def _host_fallback_count(self, op: int, cause: str) -> None:
        from .utils import metrics, tracing

        self._reg().counter("sidecar.pool.host_fallbacks").inc()
        metrics.counter("sidecar.host_fallbacks").inc()
        metrics.event("sidecar.pool.degrade_to_host", op=op_name(op), cls=cause)
        # the degrade lands on the enclosing pool.call span: a query
        # whose answer came from the host engine says so in its trace
        tracing.annotate(host_fallback=cause)

    # -- the shared-memory data plane ----------------------------------------

    def lease(self, nbytes: int) -> ArenaRegion:
        """Lease a per-request region able to hold ``nbytes``; creates
        the slab (and uploads it to every live worker) on first use.
        Exhaustion raises retryably (RESOURCE_EXHAUSTED) so the split
        machinery engages."""
        # lease off the slab ensure_slab RETURNED — re-reading
        # self._slab here races a concurrent set_arena()/shutdown()
        # nulling it (a closed slab raises cleanly; None would not)
        return self.ensure_slab(min_bytes=0).lease(nbytes)

    def ensure_slab(self, min_bytes: int = 0) -> ArenaSlab:
        """Create the pool's slab arena if none exists — sized
        ``max(SRJTORCH_ARENA_SLAB_BYTES, min_bytes + header)`` AT CREATION
        only — and upload the memfd to every live worker in slab mode.
        An already-created slab is returned as-is regardless of
        ``min_bytes`` (growing it would mean a re-upload to every
        worker mid-traffic; an oversized lease instead raises
        RESOURCE_EXHAUSTED so retry-with-split engages). Returns the
        slab. The memfd outlives any single worker: respawns re-upload
        it (re-hydration), so a kill -9 never strands the data plane."""
        from . import memgov
        from .utils.errors import DeadlineExceeded

        with self._lock:
            if self._slab is not None:
                return self._slab
            if self._closed:
                # a lease after shutdown would mint a slab nobody ever
                # closes (the suite's leak tripwire would catch it at
                # session end; refuse up front instead)
                raise ValueError("ensure_slab on a shut-down pool")
            want = self._slab_bytes
            if want is None:
                want = _env_int("SRJTORCH_ARENA_SLAB_BYTES")
            want = max(int(want), int(min_bytes) + REGION_HDR_LEN)
            slab = ArenaSlab(want)
            self._slab = slab
            memgov.catalog().register_host_bytes(
                "sidecar.pool.arena", slab.size, pinned=True, kind="arena"
            )
            live = [w for w in self._workers if w.alive]
        # the upload round-trips run OUTSIDE the pool lock (a slow
        # worker must not stall routing), serialized per worker
        for w in live:
            try:
                with w.io_lock:
                    self._send_arena(w)
            except DeadlineExceeded:
                # the QUERY's budget died mid-upload: the worker is
                # healthy, and eating this would kill a live worker and
                # lose the deadline signal
                raise
            except Exception as e:  # srjt-lint: allow-broad-except(an upload failure marks THIS worker dead and routing continues on its peers; the slab itself stays valid for the survivors)
                self._on_worker_failure(w, e)
        return slab

    def set_arena(self, size: int) -> ArenaSlab:
        """Create — or REPLACE — the pool's slab arena at ``size``
        bytes (rounded up to a power of two) and upload it to every
        live worker. Replacing releases and munmaps the old slab first;
        a replace with regions still leased is a caller bug and raises
        (the old pages are about to vanish under those leases)."""
        # outstanding-check and slab detach must be ONE critical
        # section: dropping the lock between them lets a concurrent
        # lease() slip in and get its region munmapped out from under
        # it (counted as a region leak it never caused)
        with self._lock:
            slab = self._slab
            if slab is not None and slab.outstanding:
                raise ValueError(
                    "set_arena: cannot replace a slab with "
                    f"{slab.outstanding} regions still leased"
                )
            self._slab = None
            self._slab_bytes = int(size)
            if slab is not None:
                # unregister INSIDE the critical section, like
                # _close_slab — outside it, a concurrent ensure_slab's
                # fresh registration would be the one deleted
                from . import memgov

                memgov.catalog().unregister("sidecar.pool.arena")
        if slab is not None:
            slab.close()
        return self.ensure_slab()

    def _send_arena(self, w: _Worker) -> None:
        """OP_SET_ARENA with the slab memfd over SCM_RIGHTS on the
        worker's supervised socket (legacy framing: the fd transfer is
        control plane — 16 payload bytes, size + slab mode word).
        Records WHICH socket carried the upload (worker-side arena
        state is per-connection)."""
        import array
        import socket as socket_mod

        c = w.client
        if c._sock is None:
            c.connect()
        # the slab reference is read under the pool lock (a concurrent
        # set_arena()/_close_slab() nulls the attribute) — the upload itself stays OUTSIDE the lock, and a
        # replace cannot munmap the pages mid-send because set_arena
        # refuses while regions are leased and re-uploads every live
        # worker itself afterwards
        with self._lock:
            slab = self._slab
        if slab is None:
            from .utils.errors import RetryableError

            raise RetryableError(
                f"sidecar pool: UNAVAILABLE: arena slab torn down while "
                f"re-hydrating w{w.wid} (set_arena/shutdown in flight)"
            )
        hdr = struct.pack("<IQ", OP_SET_ARENA, 16) + struct.pack(
            "<QQ", slab.size, ARENA_MODE_SLAB
        )
        c._sock.sendmsg(
            [hdr],
            [(
                socket_mod.SOL_SOCKET,
                socket_mod.SCM_RIGHTS,
                array.array("i", [slab.fd]).tobytes(),
            )],
        )
        status, rlen = struct.unpack("<IQ", sidecar._recv_exact(c._sock, 12))
        body = sidecar._recv_exact(c._sock, rlen) if rlen else b""
        if (status & ~_FLAG_MASK) != STATUS_OK:
            from .utils.errors import RetryableError

            raise RetryableError(
                f"sidecar pool: SET_ARENA failed on w{w.wid}: "
                f"{body.decode('utf-8', 'replace')}"
            )
        w.arena_conn = c._sock

    def _ensure_arena(self, w: _Worker) -> None:
        """Replay SET_ARENA when the supervised connection is not the
        one that carried the last upload — a timeout redial, a desync
        close, or a fresh client all silently dropped the worker-side
        mapping, and a region op on such a connection would error (or
        worse, a stale client would trust stale pages)."""
        c = w.client
        if c._sock is not None and c._sock is w.arena_conn:
            return
        self._send_arena(w)
        self._reg().counter("sidecar.pool.rehydrations").inc()
        from .utils import metrics

        metrics.event("sidecar.pool.rehydrate", wid=w.wid, cause="reconnect")

    # -- observability -------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-clean pool state for runtime.stats_report()."""
        reg = self._reg()
        with self._lock:
            slab = self._slab
            return {
                "size": self.size,
                "live": self.live_count(),
                "routable": self.routable_count(),
                "workers": {
                    f"w{w.wid}": {
                        "alive": w.alive,
                        "quarantined": w.quarantined,
                        "strikes": w.strikes,
                        "spawns": w.spawns,
                        "pid": None if w.proc is None else w.proc.pid,
                    }
                    for w in self._workers
                },
                "failovers": reg.value("sidecar.pool.failovers"),
                "worker_deaths": reg.value("sidecar.pool.worker_deaths"),
                "respawns": reg.value("sidecar.pool.respawns"),
                "rehydrations": reg.value("sidecar.pool.rehydrations"),
                "host_fallbacks": reg.value("sidecar.pool.host_fallbacks"),
                "quarantines": reg.value("sidecar.pool.quarantines"),
                "reinstatements": reg.value("sidecar.pool.reinstatements"),
                "hedges_launched": reg.value("sidecar.pool.hedges_launched"),
                "hedges_won": reg.value("sidecar.pool.hedges_won"),
                "arena_bytes": 0 if slab is None else slab.size,
                "slab_regions": 0 if slab is None else slab.outstanding,
                "region_leases": reg.value("sidecar.pool.region_leases"),
                "region_leaks": reg.value("sidecar.pool.region_leaks"),
            }

    def worker_stats(self, fold: bool = True) -> Dict[str, dict]:
        """Poll every LIVE worker's STATS verb; returns snapshots keyed
        per worker id. With ``fold`` (default) each worker's counters
        land in this process's registry as ``sidecar.worker.w<id>.*``
        gauges — the per-worker keying runtime.device_stats merges
        instead of assuming one connection."""
        from .utils import metrics
        from .utils.errors import RetryableError

        out: Dict[str, dict] = {}
        for w in list(self._workers):
            if not w.alive or w.client is None:
                continue
            try:
                # one frame at a time on the slot's supervised
                # connection; slab regions are private per request, so
                # a STATS poll never clobbers an in-flight data op
                with w.io_lock:
                    stats = w.client.worker_stats(fold=False)
            except RetryableError:
                continue  # died between the liveness check and the poll
            out[f"w{w.wid}"] = stats
            if fold:
                counters = (stats.get("snapshot") or {}).get("counters") or {}
                # worker counters already live under sidecar.worker.*;
                # strip that base before the per-worker prefix so the
                # fold lands at sidecar.worker.w<id>.requests.PING, not
                # a stuttered sidecar.worker.w0.sidecar.worker....
                base = "sidecar.worker."
                metrics.fold_worker_counters(
                    {
                        (k[len(base):] if k.startswith(base) else k): v
                        for k, v in counters.items()
                    },
                    prefix=f"sidecar.worker.w{w.wid}.",
                )
        return out


# ---------------------------------------------------------------------------
# process-global pool (one chip, one supervised pool — mirrors breaker())
# ---------------------------------------------------------------------------

_POOL: Optional[SidecarPool] = None
_POOL_LOCK = threading.Lock()


def connect_pool(**kwargs) -> SidecarPool:
    """Create (or return) the process-global pool. Keyword overrides
    apply only on first creation."""
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            _POOL = SidecarPool(**kwargs)
    return _POOL


def current_pool() -> Optional[SidecarPool]:
    """The process-global pool if one is connected, else None — stats
    paths (runtime.device_stats / stats_report) consult this without
    ever spawning workers as a side effect."""
    return _POOL


def shutdown_pool() -> None:
    global _POOL
    with _POOL_LOCK:
        p, _POOL = _POOL, None
    if p is not None:
        p.shutdown()


def stats_section() -> Optional[dict]:
    """The ``pool`` section of runtime.stats_report(): None when no
    pool has been connected (the seed posture)."""
    p = current_pool()
    return None if p is None else p.snapshot()


def health_section() -> dict:
    """The ``health`` section of runtime.stats_report():
    gray-failure verdicts — registry-direct, so it answers (zeros)
    even before any pool exists, plus the live pool's per-worker EWMA
    snapshot when one is connected."""
    from .utils import metrics

    reg = metrics.registry()
    out = {
        "quarantines": reg.value("sidecar.pool.quarantines"),
        "reinstatements": reg.value("sidecar.pool.reinstatements"),
        "probes": reg.value("sidecar.pool.quarantine_probes"),
        "quarantined_now": reg.value("sidecar.pool.quarantined"),
        "quarantine_fallbacks": reg.value("sidecar.pool.quarantine_fallbacks"),
    }
    p = current_pool()
    if p is not None:
        out["worker_latency"] = p._ewma.snapshot()
    return out


def hedge_section() -> dict:
    """The ``hedge`` section of runtime.stats_report():
    hedged-dispatch accounting plus the adaptive-timeout clamp counts
    from both adaptive-deadline call sites."""
    from .utils import metrics

    reg = metrics.registry()
    return {
        "launched": reg.value("sidecar.pool.hedges_launched"),
        "won": reg.value("sidecar.pool.hedges_won"),
        "cancelled": reg.value("sidecar.pool.hedges_cancelled"),
        "suppressed": reg.value("sidecar.pool.hedges_suppressed"),
        "pool_calls": reg.value("sidecar.pool.calls"),
        "adaptive_timeout_clamps": {
            "sidecar": reg.value("sidecar.adaptive_timeout_clamps"),
            "exchange": reg.value("shuffle.tcp.adaptive_timeout_clamps"),
        },
    }
