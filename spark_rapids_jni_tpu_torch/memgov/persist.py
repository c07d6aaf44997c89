"""Durable spill metadata: manifests, re-attach, orphan GC (port of the
JAX package's ``memgov/persist.py``).

The catalog's disk tier writes CRC-framed spill files, but the metadata
that makes them usable (key, kind, tree def, leaf count) lives only in
the owning process: a killed coordinator leaves every ``.frm`` under
``SRJTORCH_SPILL_DIR`` orphaned, and every checkpointed out-of-core
partition (``plan/ooc.py`` writes them under fingerprint-stable keys so
that a retry can resume) unreachable. This module closes both halves:

- **Manifests**: with ``SRJTORCH_SPILL_MANIFESTS=1``, every disk
  demotion also writes ``<frame>.mf``, a CRC-framed pickle of the
  entry's identity (key, kind, nbytes, n_leaves, owning pid, tree def).
  The payload crosses ``faultinj.maybe_torn("memgov.manifest", ...)``;
  a torn or rotted manifest reads back as None and the frame is treated
  as unprovable. Re-attached entries verify their frame's own CRCs
  lazily on the first ``get()``.
- **Startup** (``startup``, hooked into ``memgov.catalog()``): frames
  whose manifest names a provably dead owning PID are ADOPTED when they
  are durable checkpoint kinds (``partition``, ``cache``): re-registered
  into the fresh catalog at the disk tier with the manifest rewritten
  under the adopting PID (``memgov.reattached``). A dead process's
  working-set spills (``buffer`` and the rest) are RECLAIMED
  (``memgov.orphans_reclaimed``). Live owners' files are never touched.
  Default per-process spill dirs (``srjtorch-spill-<pid>``) of dead PIDs
  are swept whole: the directory's name proves the ownership.

Everything is inert with ``SRJTORCH_SPILL_MANIFESTS`` unset: no manifest
writes, no startup scan, no new files.
"""

from __future__ import annotations

import os
import pickle
import re
import struct
import tempfile
import threading
from typing import Optional

from ..utils import faultinj, integrity, knobs, metrics

__all__ = [
    "manifests_enabled",
    "manifest_path",
    "write_manifest",
    "read_manifest",
    "remove_manifest",
    "startup",
    "sweep_default_dirs",
    "stats_counters",
]

_MAGIC = b"SRJTMF01"
_HDR = struct.Struct("<II")  # payload len, payload crc

# kinds a fresh process ADOPTS from a dead owner: deliberately-durable
# checkpoints worth resuming. Everything else (working-set "buffer"
# spills, accounting kinds) is reclaimed — its catalog died with the
# process and nothing will ever re-materialize it.
ADOPT_KINDS = ("partition", "cache")

_DEFAULT_DIR_RE = re.compile(r"^srjtorch-spill-(\d+)$")


def _registry():
    return metrics.registry()


def manifests_enabled() -> bool:
    return knobs.get_bool("SRJTORCH_SPILL_MANIFESTS")


def manifest_path(frame_path: str) -> str:
    return frame_path + ".mf"


def _pid_alive(pid: int) -> bool:
    """Liveness probe on an owning PID. Only ProcessLookupError proves
    death; EPERM (a live process we may not signal) and any other
    surprise count as alive — the sweep must never reclaim a live
    process's spill."""
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        return True
    return True


# ---------------------------------------------------------------------------
# manifest read/write
# ---------------------------------------------------------------------------


def write_manifest(frame_path: str, key: str, kind: str, nbytes: int,
                   n_leaves: int, treedef) -> bool:
    """Write the sidecar manifest for one disk frame (caller holds the
    catalog lock — same discipline as the frame write it follows).
    Failure is counted and absorbed: a manifest the volume refused
    costs re-attachability, never the spill."""
    try:
        payload = pickle.dumps(
            {
                "key": key,
                "kind": kind,
                "nbytes": int(nbytes),
                "n_leaves": int(n_leaves),
                "pid": os.getpid(),
                # pickled treedef: producer and consumer are the same
                # codebase (the spill frames themselves already assume
                # that), so cross-process unflatten is sound
                "treedef": treedef,
            },
            protocol=pickle.HIGHEST_PROTOCOL,
        )
    except Exception:
        _registry().counter("memgov.manifest_failures").inc()
        return False
    frame = _MAGIC + _HDR.pack(len(payload), integrity.checksum(payload)) + payload
    # torn-write chaos crossing: replay must treat a torn manifest as
    # absent (unprovable ownership), never as a crash
    frame = faultinj.maybe_torn("memgov.manifest", frame)
    path = manifest_path(frame_path)
    try:
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(frame)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except OSError:
        _registry().counter("memgov.manifest_failures").inc()
        return False
    _registry().counter("memgov.manifests_written").inc()
    return True


def read_manifest(frame_path: str) -> Optional[dict]:
    """The manifest dict for one frame, or None on ANY defect — magic,
    length, CRC, unpickle. A torn/rotted manifest means the frame's
    ownership and identity are unprovable; the caller leaves it."""
    path = manifest_path(frame_path)
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError:
        return None
    if raw[: len(_MAGIC)] != _MAGIC:
        _registry().counter("memgov.manifest_rot").inc()
        return None
    if len(raw) < len(_MAGIC) + _HDR.size:
        _registry().counter("memgov.manifest_rot").inc()
        return None
    ln, crc = _HDR.unpack_from(raw, len(_MAGIC))
    payload = raw[len(_MAGIC) + _HDR.size:]
    if len(payload) != ln or integrity.checksum(payload) != crc:
        _registry().counter("memgov.manifest_rot").inc()
        return None
    try:
        man = pickle.loads(payload)
    except Exception:
        _registry().counter("memgov.manifest_rot").inc()
        return None
    return man if isinstance(man, dict) else None


def remove_manifest(frame_path: str) -> None:
    """Best-effort sidecar unlink, riding every frame unlink
    (catalog close / re-materialization consume)."""
    try:
        os.unlink(manifest_path(frame_path))
    except OSError:
        pass


# ---------------------------------------------------------------------------
# startup: orphan sweep + catalog re-attach
# ---------------------------------------------------------------------------

_startup_lock = threading.Lock()


def sweep_default_dirs() -> int:
    """Reclaim default per-process spill dirs (``srjtorch-spill-<pid>``
    under the system tempdir) whose PID is provably dead — the
    satellite leak: a SIGKILL'd process using the default dir never
    reclaimed its files. The dir NAME proves ownership, so unmanifested
    frames reclaim too. Returns files reclaimed."""
    reclaimed = 0
    base = tempfile.gettempdir()
    try:
        names = os.listdir(base)
    except OSError:
        return 0
    for name in names:
        m = _DEFAULT_DIR_RE.match(name)
        if m is None:
            continue
        pid = int(m.group(1))
        if pid == os.getpid() or _pid_alive(pid):
            continue
        d = os.path.join(base, name)
        try:
            entries = os.listdir(d)
        except OSError:
            continue
        for fn in entries:
            if not (fn.endswith(".frm") or fn.endswith(".mf")
                    or fn.endswith(".mf.tmp")):
                continue  # never touch a file shape the catalog didn't write
            try:
                os.unlink(os.path.join(d, fn))
            except OSError:
                continue
            if fn.endswith(".frm"):
                reclaimed += 1
                _registry().counter("memgov.orphans_reclaimed").inc()
        try:
            os.rmdir(d)
        except OSError:
            pass
    return reclaimed


def startup(catalog) -> dict:
    """The recovery scan, hooked into ``memgov.catalog()`` when
    manifests are enabled: sweep dead default dirs, then walk the
    configured spill dir — adopt durable checkpoint frames from dead
    owners into ``catalog`` (disk tier, lazily CRC-verified) and
    reclaim their working-set frames. Never raises: a sick spill volume
    degrades recovery, not catalog construction."""
    report = {"reattached": 0, "orphans_reclaimed": 0, "skipped_live": 0,
              "unprovable": 0}
    try:
        report["orphans_reclaimed"] += sweep_default_dirs()
        spill_dir = knobs.get_str("SRJTORCH_SPILL_DIR")
        if spill_dir and os.path.isdir(spill_dir):
            _scan_shared_dir(spill_dir, catalog, report)
    except Exception as e:
        _registry().counter("memgov.persist_startup_failures").inc()
        metrics.event("memgov.persist_startup_failed", error=str(e))
    metrics.event("memgov.persist_startup", **report)
    return report


def _scan_shared_dir(spill_dir: str, catalog, report: dict) -> None:
    reg = _registry()
    try:
        names = sorted(os.listdir(spill_dir))
    except OSError:
        return
    for name in names:
        if name.endswith(".mf.tmp"):
            # an interrupted manifest replace: always safe to drop
            try:
                os.unlink(os.path.join(spill_dir, name))
            except OSError:
                pass
            continue
        if name.endswith(".mf"):
            # a sidecar whose frame is gone (crash between frame unlink
            # and sidecar unlink): drop it
            if not os.path.exists(os.path.join(spill_dir, name[:-3])):
                try:
                    os.unlink(os.path.join(spill_dir, name))
                except OSError:
                    pass
            continue
        if not name.endswith(".frm"):
            continue
        frame = os.path.join(spill_dir, name)
        man = read_manifest(frame)
        if man is None:
            # no/torn manifest: ownership unprovable, leave the frame
            # (pre-manifest processes and live writers both land here)
            report["unprovable"] += 1
            continue
        pid = int(man.get("pid", 0))
        if pid == os.getpid() or _pid_alive(pid):
            report["skipped_live"] += 1
            continue
        if (man.get("kind") in ADOPT_KINDS
                and man.get("treedef") is not None
                and _reattach(catalog, frame, man)):
            report["reattached"] += 1
            reg.counter("memgov.reattached").inc()
            metrics.event("memgov.reattach", key=man.get("key"),
                          kind=man.get("kind"), from_pid=pid)
        else:
            try:
                os.unlink(frame)
            except OSError:
                report["unprovable"] += 1
                continue
            remove_manifest(frame)
            report["orphans_reclaimed"] += 1
            reg.counter("memgov.orphans_reclaimed").inc()
            metrics.event("memgov.orphan_reclaimed", key=man.get("key"),
                          kind=man.get("kind"), from_pid=pid)


def _reattach(catalog, frame: str, man: dict) -> bool:
    """Re-register one surviving disk frame into a fresh catalog at the
    disk tier. The frame's own CRCs verify lazily on first ``get()``;
    rot there retires the entry and raises retryable DataCorruption —
    the caller's lineage recompute engages exactly as for same-process
    rot. The manifest is rewritten under the adopting PID first, so a
    second recoverer probing later sees a live owner."""
    from .catalog import SpillableHandle

    key = man.get("key")
    if not key:
        return False
    if not write_manifest(frame, key, man["kind"], man["nbytes"],
                          man["n_leaves"], man["treedef"]):
        return False
    with catalog._lock:
        if key in catalog._entries:
            return False  # a live entry always wins over a dead twin
        h = SpillableHandle(catalog, key, man["kind"], man["nbytes"],
                            man["treedef"], None)
        h._n_leaves = int(man["n_leaves"])
        h._disk_path = frame
        catalog._seq += 1
        h._seq = catalog._seq
        catalog._entries[key] = h
        catalog._update_gauges_locked()
    return True


def stats_counters() -> dict:
    """The persist half of the ``durability`` stats section."""
    reg = _registry()
    return {
        "manifests_written": reg.value("memgov.manifests_written"),
        "manifest_rot": reg.value("memgov.manifest_rot"),
        "manifest_failures": reg.value("memgov.manifest_failures"),
        "reattached": reg.value("memgov.reattached"),
        "orphans_reclaimed": reg.value("memgov.orphans_reclaimed"),
    }
