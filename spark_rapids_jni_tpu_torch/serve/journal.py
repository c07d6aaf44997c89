"""Durable query journal: crash-recoverable serving (the port of the JAX
package's ``serve/journal.py``).

Every failure domain BELOW the coordinator already recovers — pool
workers fail over, ranks die and lineage-replay, spills
rot and recompute — but the serving process itself was the
last single point of loss: a coordinator crash forgot every queued and
in-flight query and discarded the completed answers clients were about
to read. This module is the durable metadata that closes it, Spark's
WAL discipline applied to the serve tier:

- ``Scheduler.submit`` appends one fsync'd CRC-framed **submit record**
  (client idempotency key, parameterized plan fingerprint + literal
  bindings, tenant/priority/deadline/memory estimate) to a segmented
  append-only log under ``SRJTORCH_JOURNAL_DIR`` before the handle is
  returned; **state records** (dispatched/done/failed/cancelled/shed/
  expired) follow after the fact, strictly outside the dispatch lock
  like every other event write. A DONE record carries the result's
  ``result_digest`` so a restarted coordinator answers a duplicate
  submission idempotently (``DigestAnswer``) instead of re-running it.
- **Replay** (at journal open, and via ``replay()`` for tests) walks
  the segments in order, applies submits then states (a dispatch-slot
  state write may land before the submitter's record under concurrency
  — replay is order-insensitive by construction), and TRUNCATES any
  torn tail: a short header, a truncated payload, or a CRC mismatch
  ends that segment (counted ``journal.truncated_records``; the live
  journal also physically truncates the tail so the directory never
  accumulates rot). Any byte-prefix of a valid journal replays to a
  consistent state — the property the durability tests hold at every
  boundary.
- **Recovery** (``recover``): journaled-but-incomplete queries are
  resubmitted through the plan cache's rebind path — the caller
  resolves each record's parameterized fingerprint to a template plan
  + tables, the journaled literal bindings are rebound in
  (``rebind_literals``), and the resubmission carries
  ``recovered=True`` so the flight recorder annotates the restart seam.

Failure posture: a journal WRITE failure (full disk, dead mount)
degrades — counted ``journal.append_failures``, the journal disarms —
to today's volatile serving, never blocking admission. With
``SRJTORCH_JOURNAL_DIR`` unset the module is inert: no files, no fsync,
one env read per submit.

On-disk format, per segment (``seg-<n>.jrnl``)::

    SRJTJRN1 [u32 len][u32 crc][payload: len bytes of JSON] ...

CRC is utils/integrity's 32-bit checksum over the payload. Records
cross ``faultinj.maybe_torn("journal.append", frame)`` so the
``torn_write`` chaos kind tears them deterministically.
"""

from __future__ import annotations

import json
import os
import struct
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..utils import faultinj, integrity, knobs, metrics

__all__ = [
    "QueryJournal",
    "JournalState",
    "DigestAnswer",
    "active",
    "reset",
    "replay",
    "result_digest",
    "recover",
    "stats_section",
]

_MAGIC = b"SRJTJRN1"
_HDR = struct.Struct("<II")  # payload len, payload crc

# terminal states: a jid at one of these never resubmits on recovery
TERMINAL = ("done", "failed", "cancelled", "shed", "expired")


def _registry():
    return metrics.registry()


class DigestAnswer:
    """The idempotent answer for a duplicate submission whose original
    completed before the crash: the journaled result digest, NOT the
    result bytes (the journal stores metadata, not data). A client
    holding the pre-crash result verifies it against ``digest``; one
    that lost the result resubmits under a FRESH idempotency key to
    recompute. ``QueryHandle.result()`` returns this sentinel for
    idempotency-key hits."""

    __slots__ = ("idempotency_key", "digest", "jid")

    def __init__(self, idempotency_key: str, digest: int, jid: str):
        self.idempotency_key = idempotency_key
        self.digest = int(digest)
        self.jid = jid

    def matches(self, value) -> bool:
        """True iff ``value`` digests to the journaled answer."""
        return result_digest(value) == self.digest

    def __repr__(self):
        return (f"DigestAnswer(idem={self.idempotency_key!r}, "
                f"digest=0x{self.digest:08x}, jid={self.jid})")


def _tree(value, leaves: list) -> str:
    """Render ``value`` as the reference's jax treedef of the same result
    renders (``PyTreeDef(...)`` without the wrapper), appending the
    leaves in jax's flatten order: a port ``Table`` / ``Column`` as the
    reference's registered pytree nodes (a Column's children are data,
    validity, offsets, chars, child, children; its leaves carry the
    reference's numpy storage type), tuples, lists and dicts (keys in
    sorted order) as jax's containers, None as an empty node, anything
    else as one leaf."""
    from ..columnar import Column, Table

    if value is None:
        return "None"
    if isinstance(value, Table):
        inner = ", ".join(_tree(c, leaves) for c in value.columns)
        return f"CustomNode(Table[{tuple(value.names)!r}], [{inner}])"
    if isinstance(value, Column):
        d = value.dtype
        data = value.data
        if data is not None:
            data = _host_np(data)
            if d.is_fixed_width:
                data = data.view(d.np_dtype)
        parts = [data, value.validity, value.offsets, value.chars, value.child,
                 value.children]
        inner = ", ".join(
            _tree(p if not hasattr(p, "detach") else _host_np(p), leaves) for p in parts
        )
        return f"CustomNode(Column[{(d, value.child_names)!r}], [{inner}])"
    if isinstance(value, tuple) and not hasattr(value, "_fields"):
        items = [_tree(v, leaves) for v in value]
        return "(" + ", ".join(items) + ("," if len(items) == 1 else "") + ")"
    if isinstance(value, list):
        return "[" + ", ".join(_tree(v, leaves) for v in value) + "]"
    if isinstance(value, dict):
        keys = sorted(value)
        return "{" + ", ".join(f"{k!r}: {_tree(value[k], leaves)}" for k in keys) + "}"
    leaves.append(_host_np(value) if hasattr(value, "detach") else value)
    return "*"


def _host_np(t):
    return t.detach().contiguous().cpu().numpy() if hasattr(t, "detach") else t


def result_digest(value) -> int:
    """Order-stable 32-bit digest of a query result: chained CRC over the
    tree rendering (the reference's ``repr(treedef)`` of the same result)
    plus every leaf's storage dtype and bytes, so a result bit-identical
    to the reference's digests to the reference's value."""
    import numpy as np

    leaves: list = []
    crc = integrity.checksum(f"PyTreeDef({_tree(value, leaves)})".encode())
    for leaf in leaves:
        try:
            arr = np.asarray(leaf)
            crc = integrity.checksum(str(arr.dtype).encode(), crc)
            crc = integrity.checksum(arr.tobytes(), crc)
        except (TypeError, ValueError):
            # a non-array leaf: its repr is the stable rendering
            crc = integrity.checksum(repr(leaf).encode(), crc)
    return crc


# ---------------------------------------------------------------------------
# replayed view
# ---------------------------------------------------------------------------


class JournalState:
    """The consistent state a journal prefix replays to: submit records
    by jid with their latest state, plus the idempotency-key index."""

    __slots__ = ("records", "replayed", "truncated", "segments")

    def __init__(self):
        # jid -> {"rec": submit record, "state": str, "digest": int|None,
        #          "cause": str|None}
        self.records: Dict[str, dict] = {}
        self.replayed = 0
        self.truncated = 0
        self.segments = 0

    def apply_submit(self, rec: dict) -> None:
        jid = rec.get("jid")
        if not jid:
            return
        self.records.setdefault(
            jid, {"rec": rec, "state": "submitted", "digest": None,
                  "cause": None}
        )["rec"] = rec

    def apply_state(self, rec: dict) -> None:
        jid = rec.get("jid")
        entry = self.records.get(jid)
        if entry is None:
            return  # state for a submit the torn tail ate: ignorable
        state = rec.get("state")
        if entry["state"] in TERMINAL:
            return  # terminal is sticky: replay never resurrects work
        entry["state"] = state
        if rec.get("digest") is not None:
            entry["digest"] = int(rec["digest"])
        if rec.get("cause") is not None:
            entry["cause"] = rec["cause"]

    def incomplete(self) -> List[dict]:
        """Submit records with no terminal state, deduplicated by
        idempotency key (two pre-crash submissions of one idem key
        resubmit once) — recovery's work list, in journal order."""
        seen_idem: set = set()
        out = []
        for entry in self.records.values():
            if entry["state"] in TERMINAL:
                continue
            idem = entry["rec"].get("idem")
            if idem is not None:
                if idem in seen_idem:
                    continue
                seen_idem.add(idem)
            out.append(entry["rec"])
        return out

    def done_digest(self, idempotency_key: str) -> Optional[Tuple[str, int]]:
        """(jid, digest) of the DONE record journaled under this
        idempotency key, or None — the duplicate-submission index."""
        for jid, entry in self.records.items():
            if (entry["rec"].get("idem") == idempotency_key
                    and entry["state"] == "done"
                    and entry["digest"] is not None):
                return jid, entry["digest"]
        return None

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for entry in self.records.values():
            out[entry["state"]] = out.get(entry["state"], 0) + 1
        return out


def _segment_files(path: str) -> List[str]:
    try:
        names = os.listdir(path)
    except OSError:
        return []
    return sorted(
        os.path.join(path, n) for n in names
        if n.startswith("seg-") and n.endswith(".jrnl")
    )


def _replay_segment(path: str, state: JournalState) -> int:
    """Apply one segment into ``state``; returns the byte offset of the
    first torn/invalid frame (== file size when the segment is clean),
    so the opener can physically truncate the tail. Submits apply in a
    first pass and states in a second: under concurrency a dispatch
    slot's state write may legally land before the submitter's record."""
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError:
        return 0
    state.segments += 1
    if raw[: len(_MAGIC)] != _MAGIC:
        state.truncated += 1
        return 0
    off = len(_MAGIC)
    frames: List[dict] = []
    while off < len(raw):
        if off + _HDR.size > len(raw):
            state.truncated += 1
            break
        ln, crc = _HDR.unpack_from(raw, off)
        payload = raw[off + _HDR.size: off + _HDR.size + ln]
        if len(payload) != ln or integrity.checksum(payload) != crc:
            state.truncated += 1
            break
        try:
            frames.append(json.loads(payload.decode()))
        except (UnicodeDecodeError, ValueError):
            state.truncated += 1
            break
        off += _HDR.size + ln
    for rec in frames:
        if rec.get("t") == "submit":
            state.apply_submit(rec)
            state.replayed += 1
    for rec in frames:
        if rec.get("t") == "state":
            state.apply_state(rec)
            state.replayed += 1
    return off


def replay(path: str) -> JournalState:
    """Pure read: replay every segment under ``path`` into a
    JournalState (no truncation, no counters) — the property tests'
    entry point; the live journal replays through the same frame walk."""
    state = JournalState()
    for seg in _segment_files(path):
        _replay_segment(seg, state)
    return state


# ---------------------------------------------------------------------------
# the journal
# ---------------------------------------------------------------------------


class QueryJournal:
    """Segmented fsync'd append-only journal under one directory. One
    instance per process (``active()``); appends are serialized by one
    lock (submitters and dispatch slots both write), and the in-memory
    JournalState is maintained live so idempotency lookups see both the
    pre-crash replay and this process's own completions."""

    def __init__(self, path: str, segment_bytes: Optional[int] = None,
                 fsync: Optional[bool] = None):
        self.path = path
        self._segment_bytes = int(
            knobs.get_int("SRJTORCH_JOURNAL_SEGMENT_BYTES")
            if segment_bytes is None else segment_bytes
        )
        self._fsync = bool(
            knobs.get_bool("SRJTORCH_JOURNAL_FSYNC") if fsync is None else fsync
        )
        self._lock = threading.Lock()
        self._file = None
        self._file_bytes = 0
        self._degraded = False
        self._closed = False
        os.makedirs(path, exist_ok=True)
        # replay what a predecessor left, physically truncating any torn
        # tail so the directory carries no rot forward
        self.state = JournalState()
        segs = _segment_files(path)
        for seg in segs:
            good = _replay_segment(seg, self.state)
            try:
                if good < os.path.getsize(seg):
                    with open(seg, "rb+") as f:
                        f.truncate(good)
            except OSError:
                pass
        reg = _registry()
        if self.state.replayed:
            reg.counter("journal.replays").inc()
            reg.counter("journal.replayed_records").inc(self.state.replayed)
        if self.state.truncated:
            reg.counter("journal.truncated_records").inc(self.state.truncated)
        # appends always open a FRESH segment: never write after a
        # predecessor's tail, torn or clean
        self._next_seg = 1 + max(
            (int(os.path.basename(s)[4:-5])
             for s in segs if os.path.basename(s)[4:-5].isdigit()),
            default=0,
        )

    # -- append path ---------------------------------------------------------

    def _open_segment_locked(self) -> None:
        if self._file is not None:
            try:
                self._file.close()
            except OSError:
                pass
        seg = os.path.join(self.path, f"seg-{self._next_seg:06d}.jrnl")
        self._next_seg += 1
        self._file = open(seg, "ab")
        if self._file.tell() == 0:
            self._file.write(_MAGIC)
            self._file.flush()
        self._file_bytes = self._file.tell()
        _registry().counter("journal.segments_opened").inc()

    def _append_locked(self, rec: dict) -> bool:
        try:
            payload = json.dumps(
                rec, separators=(",", ":"), sort_keys=True
            ).encode()
        except (TypeError, ValueError):
            # an unserializable binding slipped past the submit-side
            # sanitizer: journal the record opaque (replay still sees
            # the lifecycle; recovery skips the resubmit)
            slim = {k: v for k, v in rec.items()
                    if k not in ("pf", "bindings")}
            slim["opaque"] = True
            payload = json.dumps(
                slim, separators=(",", ":"), sort_keys=True, default=repr
            ).encode()
        frame = _HDR.pack(len(payload), integrity.checksum(payload)) + payload
        # torn-write chaos crossing: the frame may come back a PREFIX —
        # exactly what a crash mid-write(2) leaves for replay to truncate
        frame = faultinj.maybe_torn("journal.append", frame)
        try:
            if (self._file is None
                    or self._file_bytes + len(frame) > self._segment_bytes):
                self._open_segment_locked()
            self._file.write(frame)
            self._file.flush()
            if self._fsync:
                os.fsync(self._file.fileno())
            self._file_bytes += len(frame)
        except OSError as e:
            # the degrade contract: a sick journal volume costs the
            # durability posture, never an admission
            self._degraded = True
            _registry().counter("journal.append_failures").inc()
            metrics.event("journal.append_failed", error=str(e))
            try:
                if self._file is not None:
                    self._file.close()
            except OSError:
                pass
            self._file = None
            return False
        _registry().counter("journal.appends").inc()
        return True

    def append_submit(self, rec: dict) -> bool:
        """Append one submit record (the scheduler builds it; ``jid``
        required). Returns False when degraded/failed — the caller
        proceeds volatile either way."""
        if self._degraded or self._closed:  # srjt-race: allow-unguarded(single boolean fast-path poll; GIL-atomic, append re-checks nothing — a stale False only costs one harmless locked append)
            return False
        rec = dict(rec)
        rec["t"] = "submit"
        with self._lock:
            ok = self._append_locked(rec)
            if ok:
                self.state.apply_submit(rec)
        return ok

    def append_state(self, jid: str, state: str,
                     digest: Optional[int] = None,
                     cause: Optional[str] = None) -> bool:
        if self._degraded or self._closed:
            return False
        rec: dict = {"t": "state", "jid": jid, "state": state}
        if digest is not None:
            rec["digest"] = int(digest)
        if cause is not None:
            rec["cause"] = cause
        with self._lock:
            ok = self._append_locked(rec)
            if ok:
                self.state.apply_state(rec)
        return ok

    # -- lookups -------------------------------------------------------------

    def done_digest(self, idempotency_key: str) -> Optional[Tuple[str, int]]:
        with self._lock:
            return self.state.done_digest(idempotency_key)

    def incomplete(self) -> List[dict]:
        with self._lock:
            return self.state.incomplete()

    @property
    def degraded(self) -> bool:
        return self._degraded

    def close(self) -> None:
        with self._lock:
            self._closed = True
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass
                self._file = None

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "path": self.path,
                "degraded": self._degraded,
                "segments": self.state.segments,
                "replayed": self.state.replayed,
                "truncated": self.state.truncated,
                "states": self.state.counts(),
            }


# ---------------------------------------------------------------------------
# process-wide singleton (armed by SRJTORCH_JOURNAL_DIR)
# ---------------------------------------------------------------------------

_active_lock = threading.Lock()
_active: Optional[QueryJournal] = None
_ever_active = False


def active() -> Optional[QueryJournal]:
    """The process journal, or None when ``SRJTORCH_JOURNAL_DIR`` is unset
    (one env read — the off posture's whole cost) or journal open
    failed (counted; volatile degrade, like an append failure)."""
    global _active, _ever_active
    d = knobs.get_str("SRJTORCH_JOURNAL_DIR")
    if not d:
        return None
    j = _active
    if j is not None and j.path == d and not j._closed:
        return j
    with _active_lock:
        j = _active
        if j is None or j.path != d or j._closed:
            if j is not None and not j._closed:
                j.close()
            try:
                j = _active = QueryJournal(d)
                _ever_active = True
            except OSError as e:
                _registry().counter("journal.append_failures").inc()
                metrics.event("journal.open_failed", path=d, error=str(e))
                return None
    return j


def reset() -> None:
    """Close and discard the singleton (tests / shutdown)."""
    global _active
    with _active_lock:
        j, _active = _active, None
    if j is not None:
        j.close()


# ---------------------------------------------------------------------------
# recovery: rebind + resubmit journaled-but-incomplete work
# ---------------------------------------------------------------------------


def sanitize_bindings(bindings) -> Optional[list]:
    """Journal-side rendering of ParamFingerprint bindings: JSON-clean
    ``[tag, value, dtype_key]`` rows (numpy scalars collapse to Python
    natives; the tag re-coerces them on recovery). None when any value
    resists — the record is journaled opaque instead."""
    out = []
    for tag, value, dkey in bindings:
        if tag in ("int", "i32"):
            value = int(value)
        elif tag == "float":
            value = float(value)
        elif tag == "bool":
            value = bool(value)
        elif tag == "null":
            value = None
        else:
            return None
        out.append([tag, value, None if dkey is None else list(dkey)])
    return out


def _coerce(tag: str, value):
    """Recovery-side inverse of ``sanitize_bindings``: restore the
    exact value type class the tag pinned, so a rebound literal infers
    the same dtype the journaled plan carried."""
    if tag == "i32":
        import numpy as np

        return np.int32(value)
    if tag == "int":
        return int(value)
    if tag == "float":
        return float(value)
    if tag == "bool":
        return bool(value)
    return value


def rebind_for_record(template, rec: dict):
    """Rebind a template plan (same parameterized fingerprint) to the
    literal values a journaled submission carried. None when the record
    cannot be rebound soundly: fingerprint mismatch, binding arity
    drift, or an ambiguous slot (two template slots share one
    (tag, value, dtype) triple but want different journaled values —
    by-value rebinding cannot tell them apart)."""
    from ..plan.rewrites import parameterized_fingerprint, rebind_literals

    pf = parameterized_fingerprint(template)
    if rec.get("pf") != pf.key:
        return None
    journaled = rec.get("bindings") or []
    if len(journaled) != len(pf.bindings):
        return None
    mapping: dict = {}
    for (tag, old, dkey), row in zip(pf.bindings, journaled):
        jtag, jval = row[0], row[1]
        if jtag != tag:
            return None
        new = _coerce(jtag, jval)
        key = (tag, old, dkey)
        if key in mapping and not _values_equal(mapping[key], new):
            return None  # ambiguous slot: refuse, never guess
        mapping[key] = new
    return rebind_literals(template, mapping)


def _values_equal(a, b) -> bool:
    try:
        return type(a) is type(b) and bool(a == b)
    except Exception:  # srjt-lint: allow-broad-except(exotic literal __eq__ = not equal, never an error)
        return False


def recover(sched, resolver: Callable[[dict], Optional[tuple]],
            deadline_s: Optional[float] = None) -> dict:
    """Resubmit every journaled-but-incomplete query through
    ``sched.submit``. ``resolver(record) -> (template_plan, tables)``
    (or None to skip) is the caller's catalog: the journal stores the
    parameterized fingerprint and bindings, the application owns the
    plan shapes it serves. Resubmissions carry the original tenant/
    priority/memory estimate, the original idempotency key (a record
    whose twin already completed answers by digest instead of
    re-running — zero duplicate executions of DONE work), and
    ``recovered=True`` so the trace ring shows the restart seam.

    Returns ``{"resubmitted": [(record, handle)...], "skipped": n,
    "idempotent": n}``."""
    jrn = active()
    report = {"resubmitted": [], "skipped": 0, "idempotent": 0}
    if jrn is None:
        return report
    reg = _registry()
    for rec in jrn.incomplete():
        plan = None
        if not rec.get("opaque") and rec.get("pf"):
            resolved = resolver(rec)
            if resolved is not None:
                template, tables = resolved
                plan = rebind_for_record(template, rec)
        if plan is None:
            report["skipped"] += 1
            reg.counter("journal.recovery_skipped").inc()
            metrics.event("journal.recovery_skipped", jid=rec.get("jid"))
            continue
        handle = sched.submit(
            plan, tables,
            tenant=rec.get("tenant", "default"),
            priority=int(rec.get("priority", 0)),
            deadline_s=deadline_s,
            memory_bytes=rec.get("memory_bytes"),
            host_eligible=bool(rec.get("host_eligible", True)),
            idempotency_key=rec.get("idem"),
            recovered=True,
        )
        if isinstance(handle.result(0) if handle.done() else None,
                      DigestAnswer):
            report["idempotent"] += 1
        else:
            reg.counter("journal.recovered_resubmits").inc()
        report["resubmitted"].append((rec, handle))
    return report


def stats_section() -> Optional[dict]:
    """The journal half of the ``durability`` stats section: None until
    a journal was ever active this process (a stats poll never opens
    one), else the durable counters plus the live snapshot."""
    if not _ever_active:
        return None
    reg = _registry()
    out = {
        "appends": reg.value("journal.appends"),
        "append_failures": reg.value("journal.append_failures"),
        "replays": reg.value("journal.replays"),
        "replayed_records": reg.value("journal.replayed_records"),
        "truncated_records": reg.value("journal.truncated_records"),
        "idempotent_hits": reg.value("journal.idempotent_hits"),
        "recovered_resubmits": reg.value("journal.recovered_resubmits"),
        "recovery_skipped": reg.value("journal.recovery_skipped"),
    }
    j = _active
    if j is not None:
        out["journal"] = j.snapshot()
    return out
