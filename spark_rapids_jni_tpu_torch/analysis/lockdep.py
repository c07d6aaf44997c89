"""Runtime lockdep and the srjt-race dynamic detector for the port's
concurrent substrate (the Linux kernel lockdep idea plus FastTrack-shaped
vector-clock race detection, scoped to this package's locks and tracked
state).

Armed with ``SRJTORCH_LOCKDEP=1`` (or ``SRJTORCH_RACE=1``, which implies
it), the package ``__init__`` calls ``install()`` BEFORE any other package
import, so every ``threading.Lock/RLock/Condition``,
``Event/Semaphore/BoundedSemaphore/Barrier`` and ``Thread.start/join``
created by package (or repo test) code afterwards is a tracked shim. With
``SRJTORCH_RACE=1`` each thread also carries a vector clock advanced on
every sync edge, and state registered via ``track(obj, name)`` has its
accesses checked for happens-before ordering — two accesses to one
location, at least one a write, with unordered clocks, are reported as
``race_pairs`` with both stacks and fail the same merge gate as cycles.
Per thread, the shim keeps the stack
of currently-held tracked locks; every successful-or-attempted
acquisition of lock B while holding lock A records the directed edge
A -> B (per lock INSTANCE — two specific locks taken in both orders is
a real potential deadlock, never a same-class false positive) with one
sample stack per edge. ``time.sleep`` is wrapped too: sleeping while
holding any tracked lock is recorded as a blocking-while-locked event
(the latency-bomb the deadline tier exists to prevent). Sockets guarded
by a per-connection io_lock are the DESIGN on the sidecar data path, so
recv is deliberately not instrumented — the lint layer (SRJT006)
polices blocking calls statically instead.

At process exit each armed process writes
``<SRJTORCH_LOCKDEP_DIR>/lockdep_<pid>_<suffix>.json`` — lock sites, the
order graph, cycles (strongly connected components), self-deadlocks
(re-acquiring a held non-reentrant lock), blocking events and race pairs.
The merge gate::

    python -m spark_rapids_jni_tpu_torch.analysis.lockdep \
        --merge artifacts/lockdep_torch --out artifacts/lockdep_report.json

fails on any cycle, self-deadlock or race pair across every report.

Bootstrap constraint: the package ``__init__`` reads the arming knobs
itself, before any package module exists; this module reads its knobs
through ``utils/knobs.py``, which imports nothing of the package and
creates no lock.

Known limits (documented, not bugs): locks created before ``install()``
(or by code that did ``from threading import Lock`` at import time) are
untracked; a lock acquired in one thread and released in another leaves
a stale held entry on the acquirer. Locks created by third-party code
(torch, numpy: anything under site-packages) are never tracked.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import os
import sys
import threading
import time
import traceback
from typing import Dict, List, Optional, Tuple

from ..utils import knobs

__all__ = [
    "install",
    "uninstall",
    "is_installed",
    "isolated_state",
    "report",
    "write_report",
    "flush_report",
    "find_cycles",
    "merge_reports",
    "main",
    "track",
    "race_armed",
    "enable_race_detection",
    "disable_race_detection",
]

# originals captured at import, before any patching
_ORIG_LOCK = threading.Lock
_ORIG_RLOCK = threading.RLock
_ORIG_CONDITION = threading.Condition
_ORIG_SLEEP = time.sleep
_ORIG_EVENT = threading.Event
_ORIG_SEMAPHORE = threading.Semaphore
_ORIG_BOUNDED_SEMAPHORE = threading.BoundedSemaphore
_ORIG_BARRIER = threading.Barrier
_ORIG_THREAD_START = threading.Thread.start
_ORIG_THREAD_JOIN = threading.Thread.join

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_ROOT = os.path.dirname(_PKG_ROOT)

_MAX_BLOCKING_EVENTS = 200  # sample cap; the total is counted exactly
# a blocking acquisition that stalls this long while other locks are
# held persists the report EARLY: a real deadlock never reaches exit's
# atexit writer (a harness SIGKILLs it), but the stalled report carries the
# inverted edges the postmortem needs
_STALL_REPORT_S = 60.0


class _State:
    """One lockdep universe: the order graph + event tallies + the
    race detector's access cells. Swappable via
    ``isolated_state()`` so the deliberate-inversion unit test does
    not poison the session report the merge gate asserts on."""

    def __init__(self):
        self.mu = _ORIG_LOCK()
        self.locks: Dict[int, dict] = {}  # key -> {"site", "kind"}
        self.edges: Dict[Tuple[int, int], dict] = {}
        self.blocking: List[dict] = []
        self.blocking_total = 0
        self.self_deadlocks: List[dict] = []
        # race detection: per tracked location, the last write and the
        # reads since it — each stamped (tid, vc copy, stack, thread)
        self.cells: Dict[tuple, dict] = {}
        self.races: List[dict] = []  # sample cap; total counted exactly
        self.race_total = 0
        self.race_seen: set = set()
        self.tracked_objects = 0


_state = _State()
_session_state = _state  # the universe the merge gate asserts on
_tls = threading.local()
_installed = False
_seq_lock = _ORIG_LOCK()
_seq = 0


def _next_key() -> int:
    global _seq
    with _seq_lock:
        _seq += 1
        return _seq


def _creation_site(depth: int) -> Optional[str]:
    try:
        f = sys._getframe(depth)
    except ValueError:
        return None
    fn = f.f_code.co_filename
    # package files are ALWAYS tracked — including wheel installs where
    # the package (and so _REPO_ROOT) lives inside site-packages; the
    # site-packages rejection only filters third-party code picked up
    # via the repo-root prefix in dev checkouts (tests/, benchmarks/)
    if not fn.startswith(_PKG_ROOT + os.sep):
        if not fn.startswith(_REPO_ROOT) or "site-packages" in fn:
            return None
    if os.sep + "analysis" + os.sep in fn:
        return None  # never track our own machinery
    return f"{os.path.relpath(fn, _REPO_ROOT)}:{f.f_lineno}"


def _short_stack() -> str:
    # drop the two lockdep-internal frames at the tail
    return "".join(traceback.format_stack(limit=10)[:-2])


def _held() -> list:
    h = getattr(_tls, "held", None)
    if h is None:
        h = _tls.held = []
    return h


# ---------------------------------------------------------------------------
# vector clocks (srjt-race layer 2)
#
# Armed with SRJTORCH_RACE=1 (riding the lockdep shim), every thread
# carries a vector clock {tid: counter}. Happens-before edges advance
# it at every sync operation the shim already sees — lock release ->
# acquire, Condition wait, Thread.start/join, Event.set/wait,
# Semaphore release -> acquire, Barrier cycles — so detector cost is
# proportional to SYNC-OP count, never to data volume. Two accesses to
# the same tracked location (see track()), at least one a write, whose
# clocks are UNORDERED, are a data race: no lock, event, join, or
# barrier ordered them, so the scheduler is free to interleave the
# bytes. Both access stacks are reported.
# ---------------------------------------------------------------------------

_race_armed = False
_MAX_RACE_SAMPLES = 50
_hb_guard = _ORIG_LOCK()  # guards _srjt_hb dicts on events/barriers/sems


def _cur_vc() -> Tuple[dict, int]:
    """This thread's (vector clock, tid); the clock is mutated only by
    its own thread. Threads started through the shim get seeded with
    their parent's clock by the wrapped run() (_tracked_thread_start);
    anything else starts fresh. Deliberately NEVER calls
    threading.current_thread(): that constructor path itself touches a
    (tracked) Event and would recurse."""
    vc = getattr(_tls, "vc", None)
    if vc is None:
        tid = _next_key()
        _tls.tid = tid
        vc = _tls.vc = {tid: 1}
    return vc, _tls.tid


def _join_into(dst: dict, src: dict) -> None:
    for k, v in src.items():
        if dst.get(k, 0) < v:
            dst[k] = v


def _publish_hb(obj) -> None:
    """release/set/arrive edge: merge this thread's clock into the sync
    object's clock, then tick own component (later local events are
    strictly after the published point)."""
    vc, tid = _cur_vc()
    with _hb_guard:
        hb = getattr(obj, "_srjt_hb", None)
        if hb is None:
            try:
                obj._srjt_hb = hb = {}
            except AttributeError:
                return  # slotted foreign object: no HB channel
        _join_into(hb, vc)
    vc[tid] = vc.get(tid, 0) + 1


def _absorb_hb(obj) -> None:
    """acquire/wait/depart edge: adopt everything the sync object has
    accumulated from earlier publishers."""
    hb = getattr(obj, "_srjt_hb", None)
    if hb:
        vc, _ = _cur_vc()
        with _hb_guard:
            _join_into(vc, hb)


def _access_stack() -> str:
    # drop the two detector-internal frames at the tail
    return "".join(traceback.format_stack(limit=8)[:-2])


def _ordered_before(prev, vc: dict) -> bool:
    """Did the recorded access ``prev`` happen-before the current clock
    ``vc``? True iff prev's own-component timestamp is included in vc —
    the standard vector-clock ordering test."""
    ptid, pvc = prev[0], prev[1]
    return pvc.get(ptid, 0) <= vc.get(ptid, 0)


def _report_race(st: _State, loc: tuple, prev, cur, kind: str) -> None:
    st.race_total += 1
    key = (loc, kind)
    if key in st.race_seen:
        return
    st.race_seen.add(key)
    if len(st.races) < _MAX_RACE_SAMPLES:
        st.races.append({
            "location": f"{loc[0]}[{loc[1]!r}]",
            "kind": kind,
            "a": {"thread": prev[3], "stack": prev[2]},
            "b": {"thread": cur[3], "stack": cur[2]},
        })


def _record_access(loc: tuple, is_write: bool) -> None:
    """One access to a tracked location: check happens-before against
    the cell's last write (and, for writes, the reads since it), then
    become part of the cell. FastTrack-shaped: last-write + read-set
    per location, so memory is bounded by live locations, not access
    count."""
    if not _race_armed:
        return
    vc, tid = _cur_vc()
    cur = (tid, dict(vc), _access_stack(), threading.current_thread().name)
    st = _state
    with st.mu:
        cell = st.cells.get(loc)
        if cell is None:
            cell = st.cells[loc] = {"w": None, "r": {}}
        w = cell["w"]
        if w is not None and w[0] != tid and not _ordered_before(w, vc):
            _report_race(st, loc, w, cur,
                         "write-write" if is_write else "write-read")
        if is_write:
            for rtid, r in cell["r"].items():
                if rtid != tid and not _ordered_before(r, vc):
                    _report_race(st, loc, r, cur, "read-write")
            cell["w"] = cur
            cell["r"].clear()
        else:
            # bound the read set per cell: read-mostly locations (a
            # metric created once, read by every thread forever) must
            # not accumulate one stamped record per thread EVER — the
            # oldest reader's record goes; losing it can only miss a
            # race against that one stale read, never invent one
            if tid not in cell["r"] and len(cell["r"]) >= 16:
                cell["r"].pop(next(iter(cell["r"])))
            cell["r"][tid] = cur


# -- the track() registration API --------------------------------------------

_tracked_classes: Dict[type, type] = {}
_track_names: Dict[int, str] = {}
_STRUCT_KEY = "<keys>"


class _TrackedDict(dict):
    """dict proxy recording per-key reads/writes (plus a synthetic
    ``<keys>`` location for structural mutations vs. iteration). A
    drop-in replacement: callers install it in place of the original
    (``self._tenants = lockdep.track(self._tenants, "...")``)."""

    __slots__ = ("_srjt_name",)

    def _rec(self, key, write: bool) -> None:
        _record_access((self._srjt_name, key), write)

    def __getitem__(self, key):
        self._rec(key, False)
        return dict.__getitem__(self, key)

    def get(self, key, default=None):
        self._rec(key, False)
        return dict.get(self, key, default)

    def __contains__(self, key):
        self._rec(key, False)
        return dict.__contains__(self, key)

    def __setitem__(self, key, value):
        self._rec(key, True)
        self._rec(_STRUCT_KEY, True)
        dict.__setitem__(self, key, value)

    def setdefault(self, key, default=None):
        self._rec(key, True)
        self._rec(_STRUCT_KEY, True)
        return dict.setdefault(self, key, default)

    def __delitem__(self, key):
        self._rec(key, True)
        self._rec(_STRUCT_KEY, True)
        dict.__delitem__(self, key)

    def pop(self, key, *default):
        self._rec(key, True)
        self._rec(_STRUCT_KEY, True)
        return dict.pop(self, key, *default)

    def popitem(self):
        self._rec(_STRUCT_KEY, True)
        k, v = dict.popitem(self)
        # the removed key is only known post-hoc; its per-key write
        # must still land so a concurrent keyed read can conflict
        self._rec(k, True)
        return k, v

    def clear(self):
        self._rec(_STRUCT_KEY, True)
        for k in list(dict.keys(self)):
            self._rec(k, True)
        dict.clear(self)

    def update(self, *args, **kw):
        # record per-KEY writes, not just the structural location — a
        # bare update() racing a keyed read must share a location with
        # it or the detector never compares their clocks
        self._rec(_STRUCT_KEY, True)
        staged = dict(*args, **kw)
        for k in staged:
            self._rec(k, True)
        dict.update(self, staged)

    def __iter__(self):
        self._rec(_STRUCT_KEY, False)
        return dict.__iter__(self)

    def __len__(self):
        self._rec(_STRUCT_KEY, False)
        return dict.__len__(self)

    def keys(self):
        self._rec(_STRUCT_KEY, False)
        return dict.keys(self)

    def values(self):
        self._rec(_STRUCT_KEY, False)
        return dict.values(self)

    def items(self):
        self._rec(_STRUCT_KEY, False)
        return dict.items(self)


def _make_tracked_class(cls: type) -> type:
    orig_set = cls.__setattr__

    def __setattr__(self, key, value):
        orig_set(self, key, value)
        nm = _track_names.get(id(self))
        if nm is not None:
            _record_access((nm, key), True)

    # an empty-slots subclass keeps the layout identical, so
    # instance.__class__ reassignment works for slotted classes too;
    # the marker is what makes track() idempotent
    return type(cls.__name__, (cls,), {
        "__slots__": (), "__setattr__": __setattr__,
        "_srjt_tracked_class": True,
    })


def track(obj, name: str):
    """Register ``obj`` for dynamic race tracking (srjt-race layer 2).

    Disarmed (the default), returns ``obj`` untouched at the cost of
    one boolean read. Armed: dicts are replaced by a recording proxy
    (install the RETURN VALUE in place of the original); other objects
    have their class swapped to a subclass whose ``__setattr__``
    records every field WRITE (object tracking is write-only — it
    catches unguarded concurrent writes; per-key read/write coverage
    needs the dict proxy). Applied at construction time to the
    scheduler's tenant-lane table, the pool's worker-health records
    and hedge budget, the memgov catalog map, and the metrics-registry
    internals."""
    if not _race_armed:
        return obj
    # idempotent: re-tracking an already-tracked object (the global
    # hedge counter on every pool construction) must neither stack
    # another recording subclass NOR rename its locations — a rename
    # would split the access history a race could span. The class
    # marker (not an id() lookup) survives pid-style id recycling.
    if isinstance(obj, _TrackedDict) or getattr(
            type(obj), "_srjt_tracked_class", False):
        return obj
    st = _state
    with st.mu:
        st.tracked_objects += 1
    # per-registration unique suffix: two INSTANCES tracked under one
    # name (two pools, a test's private catalog beside the global one)
    # must never share locations — unordered accesses to different
    # objects are not a race
    name = f"{name}#{_next_key()}"
    if isinstance(obj, dict):
        d = _TrackedDict(obj)
        d._srjt_name = name
        return d
    cls = type(obj)
    sub = _tracked_classes.get(cls)
    if sub is None:
        sub = _tracked_classes[cls] = _make_tracked_class(cls)
    _track_names[id(obj)] = name
    obj.__class__ = sub
    return obj


def race_armed() -> bool:
    return _race_armed


def enable_race_detection() -> None:
    """Arm the vector-clock detector (installs the shim if needed) —
    the in-process switch tests use; production arms via SRJTORCH_RACE=1
    so the patch lands before any package lock exists."""
    global _race_armed
    install()
    _race_armed = True


def disable_race_detection() -> None:
    global _race_armed
    _race_armed = False


def _note_order_edges(node, held: list) -> None:
    """Record held -> node order-graph edges (node is a _TrackedLock or
    a semaphore's _GraphNode — anything with _key/site/_register)."""
    if not held:
        return
    st = _state
    with st.mu:
        node._register(st)
        for entry in held:
            other = entry[0]
            if other._key == node._key:
                continue
            other._register(st)
            key = (other._key, node._key)
            rec = st.edges.get(key)
            if rec is None:
                st.edges[key] = {"count": 1, "stack": _short_stack()}
            else:
                rec["count"] += 1


class _GraphNode:
    """Order-graph identity for a non-lock sync primitive (Semaphore):
    the minimal protocol _note_order_edges and the held stack need."""

    __slots__ = ("_key", "site", "kind", "_registered")

    def __init__(self, site: str, kind: str):
        self._key = _next_key()
        self.site = site
        self.kind = kind
        self._registered = False

    def _register(self, st: _State) -> None:
        if not self._registered or self._key not in st.locks:
            st.locks[self._key] = {"site": self.site, "kind": self.kind}
            self._registered = True


class _TrackedLock:
    """Shim over one Lock/RLock instance. Implements the full lock
    protocol plus the private trio (``_release_save`` /
    ``_acquire_restore`` / ``_is_owned``) threading.Condition probes
    for, so a Condition built over a tracked lock keeps the held-stack
    exact across ``wait()``. ``_hb`` is the lock's happens-before
    clock (srjt-race): releases publish into it, acquires absorb it."""

    __slots__ = ("_inner", "_key", "site", "_reentrant", "_registered",
                 "_hb")

    def __init__(self, inner, site: str, reentrant: bool):
        self._inner = inner
        self._key = _next_key()
        self.site = site
        self._reentrant = reentrant
        self._registered = False
        self._hb: Optional[dict] = None

    # -- bookkeeping ---------------------------------------------------------

    def _register(self, st: _State) -> None:
        if not self._registered or self._key not in st.locks:
            st.locks[self._key] = {
                "site": self.site,
                "kind": "RLock" if self._reentrant else "Lock",
            }
            self._registered = True

    def _note_edges(self, held: list) -> None:
        _note_order_edges(self, held)

    # -- happens-before (srjt-race layer 2) ----------------------------------

    def _hb_absorb(self) -> None:
        """Post-acquire: adopt the clock of everything released under
        this lock before us. Reads _hb while HOLDING the lock, which is
        exactly the ordering that makes the bare read safe."""
        if _race_armed and self._hb:
            vc, _ = _cur_vc()
            _join_into(vc, self._hb)

    def _hb_publish(self) -> None:
        """Pre-release (still holding): publish our clock into the
        lock, tick our own component."""
        if _race_armed:
            vc, tid = _cur_vc()
            hb = self._hb
            if hb is None:
                hb = self._hb = {}
            _join_into(hb, vc)
            vc[tid] = vc.get(tid, 0) + 1

    # -- the lock protocol ---------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1):
        held = _held()
        for entry in held:
            if entry[0] is self:
                if self._reentrant:
                    got = self._inner.acquire(blocking, timeout)
                    if got:
                        entry[1] += 1
                    return got
                # re-acquiring a held non-reentrant lock: guaranteed
                # deadlock — record it AND persist the report BEFORE
                # blocking forever (atexit never runs for a process the
                # harness has to SIGKILL)
                st = _state
                with st.mu:
                    self._register(st)
                    st.self_deadlocks.append({
                        "site": self.site,
                        "thread": threading.current_thread().name,
                        "stack": _short_stack(),
                    })
                if blocking and timeout == -1:
                    _persist_early()  # about to block forever
                return self._inner.acquire(blocking, timeout)
        # edges record the ATTEMPTED order, before any blocking: a true
        # deadlock never reaches the post-acquire line
        self._note_edges(held)
        if held and blocking and timeout == -1:
            # a wedged acquisition while other locks are held is the
            # deadlock shape: give it _STALL_REPORT_S, then persist the
            # report (both inverted edges are already recorded) and
            # keep waiting so the harness timeout stays the arbiter
            got = self._inner.acquire(True, _STALL_REPORT_S)
            if not got:
                _persist_early()
                got = self._inner.acquire(True, -1)
        else:
            got = self._inner.acquire(blocking, timeout)
        if got:
            held.append([self, 1])
            self._hb_absorb()
        return got

    def release(self):
        held = _held()
        if _race_armed:
            # publish BEFORE the inner release: the next acquirer must
            # see our full clock the instant the lock is free. Only the
            # FINAL release of a reentrant hold publishes.
            final = True
            for e in held:
                if e[0] is self and e[1] > 1:
                    final = False
                    break
            if final:
                self._hb_publish()
        self._inner.release()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is self:
                held[i][1] -= 1
                if held[i][1] == 0:
                    del held[i]
                return

    def __enter__(self):
        return self.acquire()

    def __exit__(self, *exc):
        self.release()

    def locked(self):
        return self._inner.locked()

    def __repr__(self):
        return f"<lockdep {self.site} over {self._inner!r}>"

    # -- threading.Condition integration -------------------------------------

    def _release_save(self):
        # Condition.wait fully releases the lock whatever its depth:
        # publish first (the notifier that acquires next must inherit
        # our clock)
        self._hb_publish()
        if self._reentrant:
            state = self._inner._release_save()
        else:
            self._inner.release()
            state = None
        held = _held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is self:
                del held[i]
                break
        return state

    def _acquire_restore(self, state):
        if self._reentrant:
            self._inner._acquire_restore(state)
            depth = state[0] if isinstance(state, tuple) else 1
        else:
            self._inner.acquire()
            depth = 1
        held = _held()
        self._note_edges(held)
        held.append([self, depth])
        self._hb_absorb()

    def _is_owned(self):
        if self._reentrant:
            return self._inner._is_owned()
        # plain-Lock heuristic, same as threading.Condition's fallback
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True


# -- the patched factories ---------------------------------------------------


def _make_lock():
    inner = _ORIG_LOCK()
    site = _creation_site(2)
    return inner if site is None else _TrackedLock(inner, site, False)


def _make_rlock():
    inner = _ORIG_RLOCK()
    site = _creation_site(2)
    return inner if site is None else _TrackedLock(inner, site, True)


def _make_condition(lock=None):
    if lock is None:
        site = _creation_site(2)
        if site is not None:
            lock = _TrackedLock(_ORIG_RLOCK(), site, True)
    return _ORIG_CONDITION(lock) if lock is not None else _ORIG_CONDITION()


# -- Event / Semaphore / Barrier shims -----------------------------------------
#
# These subclasses keep the
# full stdlib behavior (and stay subclass-safe for third-party code:
# `class Foo(threading.Event)` under the patch subclasses the shim,
# which IS the original plus hooks) while feeding the two analyses:
# Semaphores join the lock-ORDER graph (an acquire while holding locks
# is a deadlock-shaped edge; a semaphore released by another thread
# leaves a stale held entry — the same documented limit as locks), and
# all three feed HAPPENS-BEFORE edges when the race detector is armed
# (set->wait, release->acquire, barrier cycles).


class _TrackedEvent(_ORIG_EVENT):
    def set(self):
        if _race_armed:
            _publish_hb(self)
        _ORIG_EVENT.set(self)

    def wait(self, timeout=None):
        got = _ORIG_EVENT.wait(self, timeout)
        if got and _race_armed:
            _absorb_hb(self)
        return got

    def is_set(self):
        got = _ORIG_EVENT.is_set(self)
        if got and _race_armed:
            # an observed True IS a synchronizing read: the caller will
            # act on state the setter published before set()
            _absorb_hb(self)
        return got


class _SemaphoreShim:
    """Mixin for Semaphore/BoundedSemaphore: order-graph edges on
    acquire-while-holding plus HB release->acquire edges."""

    def __init__(self, value=1):
        super().__init__(value)
        site = _creation_site(2)
        # only package-created semaphores join the order graph; HB
        # edges are recorded for every instance (cheap, sound)
        self._srjt_token = (
            _GraphNode(site, "Semaphore") if site is not None else None
        )

    def acquire(self, blocking=True, timeout=None):
        tok = getattr(self, "_srjt_token", None)
        held = _held()
        if tok is not None:
            _note_order_edges(tok, held)  # attempted order, pre-block
        got = super().acquire(blocking, timeout)
        if got:
            if tok is not None:
                held.append([tok, 1])
            if _race_armed:
                _absorb_hb(self)
        return got

    __enter__ = acquire

    def release(self, n=1):
        if _race_armed:
            _publish_hb(self)
        super().release(n)
        tok = getattr(self, "_srjt_token", None)
        if tok is not None:
            held = _held()
            for i in range(len(held) - 1, -1, -1):
                if held[i][0] is tok:
                    del held[i]
                    break

    def __exit__(self, *exc):
        self.release()


class _TrackedSemaphore(_SemaphoreShim, _ORIG_SEMAPHORE):
    pass


class _TrackedBoundedSemaphore(_SemaphoreShim, _ORIG_BOUNDED_SEMAPHORE):
    pass


class _TrackedBarrier(_ORIG_BARRIER):
    def wait(self, timeout=None):
        if _race_armed:
            # arrival: merge into the cycle clock — every thread's
            # pre-barrier work is ordered before every thread's
            # post-barrier work once all have arrived
            _publish_hb(self)
        idx = _ORIG_BARRIER.wait(self, timeout)
        if _race_armed:
            _absorb_hb(self)
        return idx


def _tracked_thread_start(self):
    if _race_armed:
        vc, tid = _cur_vc()
        start_clock = dict(vc)
        vc[tid] = vc.get(tid, 0) + 1
        orig_run = self.run

        def _run_and_stamp():
            # seed the child's clock from the parent's start snapshot
            # (the start edge), replacing any stub clock bootstrap
            # Event traffic may have minted before run()
            ctid = _next_key()
            _tls.tid = ctid
            cvc = dict(start_clock)
            cvc[ctid] = cvc.get(ctid, 0) + 1
            _tls.vc = cvc
            try:
                orig_run()
            finally:
                self._srjt_final_clock = dict(_tls.vc)

        self.run = _run_and_stamp
    return _ORIG_THREAD_START(self)


def _tracked_thread_join(self, timeout=None):
    r = _ORIG_THREAD_JOIN(self, timeout)
    if _race_armed and not self.is_alive():
        fin = getattr(self, "_srjt_final_clock", None)
        if fin:
            vc, _ = _cur_vc()
            _join_into(vc, fin)
    return r


def _tracked_sleep(secs):
    held = getattr(_tls, "held", None)
    if held:
        st = _state
        with st.mu:
            st.blocking_total += 1
            if len(st.blocking) < _MAX_BLOCKING_EVENTS:
                st.blocking.append({
                    "syscall": "sleep",
                    "seconds": float(secs),
                    "thread": threading.current_thread().name,
                    "locks_held": [e[0].site for e in held],
                    "stack": _short_stack(),
                })
    _ORIG_SLEEP(secs)


# -- lifecycle ---------------------------------------------------------------


def install() -> None:
    """Patch threading (Lock/RLock/Condition + Event/Semaphore/
    Barrier/Thread.start/join) and time.sleep, and register the
    exit-time report writer. Idempotent. Must run before the modules
    whose locks it should see are imported — the package ``__init__``
    does this when SRJTORCH_LOCKDEP=1 or SRJTORCH_RACE=1 (the race detector
    rides this shim: arming it arms lockdep)."""
    global _installed, _race_armed
    if knobs.get_bool("SRJTORCH_RACE"):
        _race_armed = True
    if _installed:
        return
    threading.Lock = _make_lock
    threading.RLock = _make_rlock
    threading.Condition = _make_condition
    threading.Event = _TrackedEvent
    threading.Semaphore = _TrackedSemaphore
    threading.BoundedSemaphore = _TrackedBoundedSemaphore
    threading.Barrier = _TrackedBarrier
    threading.Thread.start = _tracked_thread_start
    threading.Thread.join = _tracked_thread_join
    time.sleep = _tracked_sleep
    atexit.register(_atexit_report)
    _installed = True


def uninstall() -> None:
    global _installed, _race_armed
    _race_armed = False
    if not _installed:
        return
    threading.Lock = _ORIG_LOCK
    threading.RLock = _ORIG_RLOCK
    threading.Condition = _ORIG_CONDITION
    threading.Event = _ORIG_EVENT
    threading.Semaphore = _ORIG_SEMAPHORE
    threading.BoundedSemaphore = _ORIG_BOUNDED_SEMAPHORE
    threading.Barrier = _ORIG_BARRIER
    threading.Thread.start = _ORIG_THREAD_START
    threading.Thread.join = _ORIG_THREAD_JOIN
    time.sleep = _ORIG_SLEEP
    _installed = False


def is_installed() -> bool:
    return _installed


@contextlib.contextmanager
def isolated_state():
    """Swap in a throwaway graph for the dynamic extent of the block
    (the deliberate-inversion unit test's tool: its cycle must never
    reach the session report the merge gate asserts on)."""
    global _state
    prev = _state
    _state = _State()
    try:
        yield _state
    finally:
        _state = prev


# -- reporting ---------------------------------------------------------------


def find_cycles(edges) -> List[List[int]]:
    """Strongly connected components with >1 node (or a self-edge) in
    the key graph — each is a set of locks with circular ordering, i.e.
    a potential deadlock. Iterative Tarjan: lock graphs are small but
    stacks under chaos tests need not be."""
    graph: Dict[int, List[int]] = {}
    for a, b in edges:
        graph.setdefault(a, []).append(b)
        graph.setdefault(b, [])
    index: Dict[int, int] = {}
    low: Dict[int, int] = {}
    on_stack: Dict[int, bool] = {}
    stack: List[int] = []
    counter = [0]
    sccs: List[List[int]] = []

    for root in graph:
        if root in index:
            continue
        work = [(root, iter(graph[root]))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack[root] = True
        while work:
            node, it = work[-1]
            advanced = False
            for nxt in it:
                if nxt not in index:
                    index[nxt] = low[nxt] = counter[0]
                    counter[0] += 1
                    stack.append(nxt)
                    on_stack[nxt] = True
                    work.append((nxt, iter(graph[nxt])))
                    advanced = True
                    break
                elif on_stack.get(nxt):
                    low[node] = min(low[node], index[nxt])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                comp = []
                while True:
                    v = stack.pop()
                    on_stack[v] = False
                    comp.append(v)
                    if v == node:
                        break
                if len(comp) > 1 or (node, node) in edges:
                    sccs.append(sorted(comp))
    return sccs


def report(state: Optional[_State] = None) -> dict:
    st = _state if state is None else state
    with st.mu:
        locks = {str(k): dict(v) for k, v in st.locks.items()}
        edge_items = [
            (a, b, dict(rec)) for (a, b), rec in st.edges.items()
        ]
        blocking = list(st.blocking)
        blocking_total = st.blocking_total
        self_deadlocks = list(st.self_deadlocks)
        race_pairs = [dict(r) for r in st.races]
        race_total = st.race_total
        tracked_objects = st.tracked_objects
    site = lambda k: locks.get(str(k), {}).get("site", f"key{k}")  # noqa: E731
    cycles = [
        {"locks": [site(k) for k in comp], "keys": comp}
        for comp in find_cycles({(a, b) for a, b, _ in edge_items})
    ]
    return {
        "pid": os.getpid(),
        "argv": sys.argv,
        "locks": locks,
        "edges": [
            {"from": site(a), "to": site(b),
             "from_key": a, "to_key": b, **rec}
            for a, b, rec in edge_items
        ],
        "cycles": cycles,
        "self_deadlocks": self_deadlocks,
        "blocking_events": blocking,
        "blocking_total": blocking_total,
        # srjt-race layer 2: unordered access pairs on
        # tracked state, each with both stacks — the merge gate fails
        # on ANY of these, same discipline as cycles
        "race_pairs": race_pairs,
        "race_total": race_total,
        "race_armed": _race_armed,
        "tracked_objects": tracked_objects,
    }


def _report_dir() -> str:
    return knobs.get_str("SRJTORCH_LOCKDEP_DIR")


_report_name: Optional[str] = None


def _default_report_path() -> str:
    # one name per process, random-suffixed: Linux recycles pids, and a
    # later run's process must never overwrite an earlier tier's
    # report (a lost cycle = a false pass at the merge gate). An early
    # persist and the atexit write share the name — the later write is
    # a superset of the earlier, never a duplicate report in the merge.
    global _report_name
    if _report_name is None:
        _report_name = f"lockdep_{os.getpid()}_{os.urandom(4).hex()}.json"
    d = _report_dir()
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, _report_name)


def write_report(path: Optional[str] = None) -> str:
    if path is None:
        path = _default_report_path()
    with open(path, "w", encoding="utf-8") as f:
        json.dump(report(), f, indent=1, default=str)
    return path


def flush_report() -> None:
    """Persist the session report NOW, best-effort — for processes
    that exit via ``os._exit`` (the sidecar worker's shutdown verb),
    which skips atexit. No-op when disarmed or inside an
    ``isolated_state`` test universe."""
    _persist_early()


def _persist_early() -> None:
    """Best-effort report write from INSIDE a detected/suspected
    deadlock, so the artifact exists even when the process never
    reaches atexit (harness SIGKILL). Only when armed: unit tests that
    poke _TrackedLock directly must not scribble artifacts."""
    if not _installed or _state is not _session_state:
        return  # disarmed, or an isolated_state() test universe
    try:
        write_report()
    except OSError:
        pass


def _atexit_report() -> None:
    if not _installed:
        return
    try:
        write_report()
    except OSError:
        pass  # a read-only sandbox degrades the artifact, not exit


# -- merge + gate (the CLI) --------------------------------------------------


def merge_reports(dir_path: str) -> dict:
    reports = []
    for fn in sorted(os.listdir(dir_path)):
        if fn.startswith("lockdep_") and fn.endswith(".json"):
            with open(os.path.join(dir_path, fn), encoding="utf-8") as f:
                reports.append(json.load(f))
    merged_edges: Dict[Tuple[str, str], dict] = {}
    cycles, self_deadlocks, race_pairs = [], [], []
    locks_seen = set()
    blocking_total = 0
    race_total = 0
    race_armed_any = False
    for r in reports:
        for lk in r.get("locks", {}).values():
            locks_seen.add(lk.get("site"))
        for e in r.get("edges", []):
            key = (e["from"], e["to"])
            rec = merged_edges.setdefault(
                key, {"from": e["from"], "to": e["to"], "count": 0})
            rec["count"] += e.get("count", 1)
        for c in r.get("cycles", []):
            cycles.append({"pid": r.get("pid"), **c})
        for sd in r.get("self_deadlocks", []):
            self_deadlocks.append({"pid": r.get("pid"), **sd})
        for rp in r.get("race_pairs", []):
            race_pairs.append({"pid": r.get("pid"), **rp})
        blocking_total += r.get("blocking_total", 0)
        race_total += r.get("race_total", 0)
        race_armed_any = race_armed_any or r.get("race_armed", False)
    # cross-process inversion check: per-process cycles are
    # per-INSTANCE, so an A->B order in tier 1 and B->A in tier 2 shows
    # up only here, on the merged SITE graph. Same-site self-edges
    # (two instances from one creation site nested — the per-connection
    # io_lock pattern) are excluded from the cycle test and surfaced
    # separately: per-instance tracking already proved them acyclic
    # within every process that ran them.
    sites = sorted({s for e in merged_edges for s in e})
    idx = {s: i for i, s in enumerate(sites)}
    site_cycles = [
        {"locks": [sites[k] for k in comp]}
        for comp in find_cycles(
            {(idx[a], idx[b]) for a, b in merged_edges if a != b})
    ]
    return {
        "reports": len(reports),
        "locks": sorted(x for x in locks_seen if x),
        "edges": sorted(merged_edges.values(),
                        key=lambda e: (e["from"], e["to"])),
        "cycles": cycles,
        "site_cycles": site_cycles,
        "site_self_edges": sorted(a for a, b in merged_edges if a == b),
        "self_deadlocks": self_deadlocks,
        "blocking_total": blocking_total,
        "race_pairs": race_pairs,
        "race_total": race_total,
        "race_armed": race_armed_any,
    }


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m spark_rapids_jni_tpu_torch.analysis.lockdep",
        description="merge per-process lockdep reports and gate on "
        "zero lock-order cycles and race pairs")
    ap.add_argument("--merge", default=None,
                    help="directory of lockdep_<pid>.json reports "
                    "(default: SRJTORCH_LOCKDEP_DIR)")
    ap.add_argument("--out", default=None,
                    help="write the merged report here")
    ap.add_argument("--allow-empty", action="store_true",
                    help="do not fail when no reports were found")
    args = ap.parse_args(argv)
    d = args.merge or _report_dir()
    if not os.path.isdir(d):
        if args.allow_empty:
            print(f"lockdep: no report dir {d}")
            return 0
        print(f"lockdep: report dir {d} missing — was SRJTORCH_LOCKDEP=1 "
              "armed?", file=sys.stderr)
        return 2
    merged = merge_reports(d)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(merged, f, indent=1)
    if merged["reports"] == 0 and not args.allow_empty:
        print("lockdep: zero reports found — was SRJTORCH_LOCKDEP=1 armed?",
              file=sys.stderr)
        return 2
    bad = (merged["cycles"] or merged["self_deadlocks"]
           or merged["site_cycles"] or merged["race_pairs"])
    print(f"lockdep: {merged['reports']} report(s), "
          f"{len(merged['locks'])} lock site(s), "
          f"{len(merged['edges'])} edge(s), "
          f"{len(merged['cycles'])} cycle(s), "
          f"{len(merged['site_cycles'])} cross-process site cycle(s), "
          f"{len(merged['self_deadlocks'])} self-deadlock(s), "
          f"{merged['blocking_total']} blocking-while-locked event(s), "
          f"{merged['race_total']} race(s)"
          + ("" if merged["race_armed"] else " (race detector unarmed)"))
    for c in merged["cycles"]:
        print(f"  CYCLE (pid {c.get('pid')}): " + " -> ".join(c["locks"]),
              file=sys.stderr)
    for c in merged["site_cycles"]:
        print("  SITE CYCLE (cross-process): " + " -> ".join(c["locks"]),
              file=sys.stderr)
    for sd in merged["self_deadlocks"]:
        print(f"  SELF-DEADLOCK (pid {sd.get('pid')}): {sd.get('site')}",
              file=sys.stderr)
    for rp in merged["race_pairs"]:
        print(f"  RACE (pid {rp.get('pid')}): {rp.get('kind')} on "
              f"{rp.get('location')} [{rp['a'].get('thread')} vs "
              f"{rp['b'].get('thread')}]", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
