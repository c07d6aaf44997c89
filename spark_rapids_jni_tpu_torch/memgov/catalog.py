"""Spillable buffer catalog: the memory hierarchy's demotion tier (port of
the JAX package's ``memgov/catalog.py``).

The reference plugin backs every cached batch with its spill framework:
device buffers demote to host, host to disk, and everything
re-materializes on access. ``BufferCatalog`` is that framework for the
port. A ``SpillableHandle`` wraps a value made of tensors (a bare tensor,
a columnar ``Table`` or ``Column``, or tuples, lists and dicts of them)
with pin/unpin semantics, LRU-ordered demotion device->host (numpy)
->disk (``SRJTORCH_SPILL_DIR``) under pressure, and transparent
re-materialization on ``get()`` back onto the device each tensor was
registered on. Demoted leaves are exact byte copies, so a
spill->re-materialize cycle is bit-identical.

The leaf walk. The reference flattens with ``jax.tree_util`` (a Table's
columns in order; a Column's data, validity, offsets, chars, child and
struct children, absent slots skipped). ``flatten`` walks the port's
handles in that order and records what ``unflatten`` needs to rebuild
them: names, dtypes, the slot each tensor filled, and each tensor's
torch dtype and device. A Column's fixed-width data demotes in the
reference's storage type (FLOAT64 as uint64 bits, DECIMAL128 as uint32
limbs), so a spilled table's host arrays, and its disk frame, carry the
reference's bytes.

Disk spills are columnar frames (``columnar/frames.py``: magic, schema
header and per-leaf CRCs verified on re-materialization), so a
bit-rotted or truncated spill raises the retryable ``DataCorruption``
instead of feeding wrong bytes back into a query. Containers of the
reference's older layout (the ``SRJTSPL1`` CRC envelope around npz, and
plain npz) still load.

Accounting-only entries (``register_host_bytes``) carry a size but no
payload; they make host-tier consumers visible to the budget without
ever spilling.

A spill frees the CATALOG's reference; tensors a caller already holds
from ``get()`` stay valid, so the accounting is advisory until the last
reference drops.

Observability is registry-direct: ``memgov.spills`` /
``memgov.spilled_bytes`` / ``memgov.respilled`` /
``memgov.rematerialized`` / ``memgov.rematerialized_bytes`` /
``memgov.spill_failures`` counters, ``memgov.spill_us`` /
``memgov.rematerialize_us`` histograms, and the
``memgov.catalog.*_bytes``, ``memgov.arena_*`` and ``memgov.cache_*``
gauges. Every demotion crosses ``faultinj.maybe_inject("memgov.spill")``:
an injected ``spill_fail`` leaves the entry resident and is counted,
never raised past the pressure loop.
"""

from __future__ import annotations

import os
import re
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils.errors import RetryableError

__all__ = [
    "TIER_DEVICE",
    "TIER_HOST",
    "TIER_DISK",
    "SpillableHandle",
    "BufferCatalog",
    "flatten",
    "unflatten",
    "tree_leaves",
]

TIER_DEVICE = "device"
TIER_HOST = "host"
TIER_DISK = "disk"

# the reference's pre-frame disk container: [magic 8][u32 crc][u64 len][npz]
_SPILL_MAGIC = b"SRJTSPL1"


def _registry():
    from ..utils import metrics

    return metrics.registry()


# ---------------------------------------------------------------------------
# the leaf walk (the reference's jax.tree_util flatten, over the port's
# handles)
# ---------------------------------------------------------------------------

_COLUMN_SLOTS = ("data", "validity", "offsets", "chars")


def _np_of(t_dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=t_dtype).numpy().dtype


def _leaf(t: torch.Tensor, leaves: list, view=None) -> tuple:
    """Record one tensor; its def is (torch dtype, host view dtype, device)."""
    leaves.append(t)
    host = np.dtype(view) if view is not None else _np_of(t.dtype)
    return ("L", t.dtype, host.str, str(t.device))


def _flatten_column(col, leaves: list) -> tuple:
    slots = []
    for slot in _COLUMN_SLOTS:
        t = getattr(col, slot)
        if t is None:
            slots.append(None)
        else:
            view = col.dtype.np_dtype if slot == "data" and col.dtype.is_fixed_width else None
            slots.append(_leaf(t, leaves, view))
    child = None if col.child is None else _flatten_column(col.child, leaves)
    children = (None if col.children is None
                else tuple(_flatten_column(c, leaves) for c in col.children))
    return ("C", col.dtype, col.child_names, tuple(slots), child, children)


def _flatten(value, leaves: list) -> tuple:
    from ..columnar.column import Column
    from ..columnar.table import Table

    if value is None:
        return ("N",)
    if isinstance(value, torch.Tensor):
        return _leaf(value, leaves)
    if isinstance(value, Table):
        return ("T", tuple(value.names),
                tuple(_flatten_column(c, leaves) for c in value.columns))
    if isinstance(value, Column):
        return _flatten_column(value, leaves)
    if isinstance(value, (tuple, list)):
        kind = "tuple" if isinstance(value, tuple) else "list"
        return (kind, tuple(_flatten(v, leaves) for v in value))
    if isinstance(value, dict):
        keys = tuple(sorted(value))  # jax.tree_util orders dict keys
        return ("dict", keys, tuple(_flatten(value[k], leaves) for k in keys))
    raise TypeError(f"memgov: cannot register a {type(value).__name__}; register "
                    "tensors, Tables, Columns, or tuples, lists and dicts of them")


def flatten(value) -> Tuple[List[torch.Tensor], tuple]:
    """``value``'s tensors in the reference's leaf order, and the def that
    rebuilds it (picklable: the durable manifests carry it)."""
    leaves: List[torch.Tensor] = []
    treedef = _flatten(value, leaves)
    return leaves, treedef


def tree_leaves(value) -> List[torch.Tensor]:
    return flatten(value)[0]


def _leaf_defs(treedef) -> list:
    """The leaf defs of ``treedef`` in leaf order."""
    out = []

    def walk(d):
        tag = d[0]
        if tag == "L":
            out.append(d)
        elif tag == "C":
            for s in d[3]:
                if s is not None:
                    out.append(s)
            if d[4] is not None:
                walk(d[4])
            if d[5] is not None:
                for c in d[5]:
                    walk(c)
        elif tag == "T":
            for c in d[2]:
                walk(c)
        elif tag in ("tuple", "list"):
            for c in d[1]:
                walk(c)
        elif tag == "dict":
            for c in d[2]:
                walk(c)

    walk(treedef)
    return out


def unflatten(treedef, leaves: List[torch.Tensor]):
    from ..columnar.column import Column
    from ..columnar.table import Table

    it = iter(leaves)

    def col(d):
        _, dtype, child_names, slots, child, children = d
        kw = {s: (None if sd is None else next(it)) for s, sd in zip(_COLUMN_SLOTS, slots)}
        c = None if child is None else col(child)
        cs = None if children is None else tuple(col(x) for x in children)
        return Column(dtype, child=c, children=cs, child_names=child_names, **kw)

    def build(d):
        tag = d[0]
        if tag == "N":
            return None
        if tag == "L":
            return next(it)
        if tag == "C":
            return col(d)
        if tag == "T":
            return Table([col(c) for c in d[2]], list(d[1]))
        if tag == "tuple":
            return tuple(build(x) for x in d[1])
        if tag == "list":
            return [build(x) for x in d[1]]
        if tag == "dict":
            return {k: build(x) for k, x in zip(d[1], d[2])}
        raise ValueError(f"memgov: unknown tree def {tag!r}")

    return build(treedef)


def _to_host(t: torch.Tensor, leafdef) -> np.ndarray:
    """device -> host: an exact byte copy in the leaf's host view."""
    a = t.detach().cpu().numpy()
    host = np.dtype(leafdef[2])
    if a.dtype != host:
        a = a.view(host)
    return np.ascontiguousarray(a)


def _to_device(a: np.ndarray, leafdef) -> torch.Tensor:
    """host -> the leaf's own device, in its own torch dtype."""
    _, t_dtype, _host, device = leafdef
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # decoded from a frame's bytes
        a = a.copy()
    want = _np_of(t_dtype)
    if a.dtype != want:
        a = a.view(want)
    return torch.from_numpy(a).to(torch.device(device))


def _nbytes(leaves) -> int:
    return sum(int(t.element_size()) * int(t.numel()) for t in leaves)


class SpillableHandle:
    """One catalog entry: a tree of tensor leaves at exactly one tier.

    Mutations happen under the owning catalog's lock (the public methods
    delegate); holders touch only ``get``/``pin``/``unpin``/``spill``/
    ``close`` and the read-only properties.
    """

    __slots__ = (
        "key",
        "kind",
        "nbytes",
        "spill_count",
        "_catalog",
        "_treedef",
        "_n_leaves",
        "_device",
        "_host",
        "_disk_path",
        "_pins",
        "_seq",
        "_closed",
    )

    def __init__(self, catalog: "BufferCatalog", key: str, kind: str,
                 nbytes: int, treedef, device_leaves: Optional[List]):
        self.key = key
        self.kind = kind
        self.nbytes = int(nbytes)
        self.spill_count = 0
        self._catalog = catalog
        self._treedef = treedef
        self._n_leaves = 0 if device_leaves is None else len(device_leaves)
        self._device = device_leaves
        self._host: Optional[List[np.ndarray]] = None
        self._disk_path: Optional[str] = None
        self._pins = 0
        self._seq = 0
        self._closed = False

    @property
    def tier(self) -> str:
        if self._device is not None:
            return TIER_DEVICE
        if self._disk_path is not None:
            return TIER_DISK
        return TIER_HOST

    @property
    def pinned(self) -> bool:
        return self._pins > 0

    @property
    def spillable(self) -> bool:
        """Payload-carrying, unpinned, and still device-resident."""
        return (
            not self._closed
            and self._treedef is not None
            and self._pins == 0
            and self._device is not None
        )

    def pin(self) -> "SpillableHandle":
        """Hold the entry at its tier (a pinned device entry never
        spills; re-materialization still works on get)."""
        with self._catalog._lock:
            self._pins += 1
        return self

    def unpin(self) -> None:
        with self._catalog._lock:
            if self._pins > 0:
                self._pins -= 1

    def get(self):
        """The wrapped value, re-materialized to its devices if it was
        demoted; refreshes its LRU position."""
        return self._catalog._get(self)

    def spill(self, to_disk: bool = False) -> None:
        """Force a demotion; a pinned entry raises ValueError."""
        self._catalog._force_spill(self, to_disk=to_disk)

    def close(self) -> None:
        self._catalog.unregister(self.key)


class BufferCatalog:
    """key -> SpillableHandle map with LRU demotion under one lock."""

    def __init__(
        self,
        spill_dir: Optional[str] = None,
        host_budget: Optional[int] = None,
        clock=time.monotonic,
    ):
        self._lock = threading.RLock()
        self._entries: Dict[str, SpillableHandle] = {}
        self._seq = 0
        self._clock = clock
        self._spill_dir = spill_dir  # resolved on the first disk spill
        if host_budget is None:
            from ..utils import knobs

            host_budget = knobs.get_int("SRJTORCH_HOST_MEMORY_BUDGET")
        self._host_budget = int(host_budget)  # 0 == unlimited

    # -- registration --------------------------------------------------------

    def register(self, key: str, value, pinned: bool = False,
                 kind: str = "buffer") -> SpillableHandle:
        """Wrap ``value`` as a spillable device-tier entry.
        Re-registering a key replaces (and closes) the previous entry."""
        leaves, treedef = flatten(value)
        nbytes = _nbytes(leaves)
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._close_locked(old)
            h = SpillableHandle(self, key, kind, nbytes, treedef, list(leaves))
            h._pins = 1 if pinned else 0
            self._seq += 1
            h._seq = self._seq
            self._entries[key] = h
            self._update_gauges_locked()
        return h

    def register_host_bytes(self, key: str, nbytes: int, pinned: bool = True,
                            kind: str = "arena") -> SpillableHandle:
        """Accounting-only HOST-tier entry: a size with no payload.
        Pinned by default: the bytes are owned elsewhere."""
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._close_locked(old)
            h = SpillableHandle(self, key, kind, int(nbytes), None, None)
            h._pins = 1 if pinned else 0
            self._seq += 1
            h._seq = self._seq
            self._entries[key] = h
            self._update_gauges_locked()
        return h

    def lookup(self, key: str) -> Optional[SpillableHandle]:
        """The live handle registered under ``key``, or None (how the
        out-of-core loop finds a prior attempt's checkpoints)."""
        with self._lock:
            h = self._entries.get(key)
            if h is None or h._closed:
                return None
            return h

    def unregister(self, key: str) -> bool:
        with self._lock:
            h = self._entries.pop(key, None)
            if h is None:
                return False
            self._close_locked(h)
            self._update_gauges_locked()
            return True

    def close(self) -> None:
        """Drop every entry (removing disk-spill files)."""
        with self._lock:
            for h in list(self._entries.values()):
                self._close_locked(h)
            self._entries.clear()
            self._update_gauges_locked()

    def _close_locked(self, h: SpillableHandle) -> None:
        h._closed = True
        h._device = None
        h._host = None
        if h._disk_path is not None:
            try:
                os.unlink(h._disk_path)
            except OSError:
                pass
            from . import persist
            persist.remove_manifest(h._disk_path)
            h._disk_path = None

    # -- accounting ----------------------------------------------------------

    def _tier_bytes_locked(self, tier: str) -> int:
        return sum(h.nbytes for h in self._entries.values() if h.tier == tier)

    def device_bytes(self) -> int:
        with self._lock:
            return self._tier_bytes_locked(TIER_DEVICE)

    def host_bytes(self) -> int:
        with self._lock:
            return self._tier_bytes_locked(TIER_HOST)

    def disk_bytes(self) -> int:
        with self._lock:
            return self._tier_bytes_locked(TIER_DISK)

    def spillable_device_bytes(self) -> int:
        """Device bytes the pressure loop may still reclaim."""
        with self._lock:
            return sum(h.nbytes for h in self._entries.values() if h.spillable)

    def pinned_device_bytes(self) -> int:
        with self._lock:
            return sum(
                h.nbytes
                for h in self._entries.values()
                if h.tier == TIER_DEVICE and not h.spillable
            )

    def kind_stats(self, kind: str) -> Tuple[int, int]:
        """(entries, bytes) of one registration kind."""
        with self._lock:
            hs = [h for h in self._entries.values() if h.kind == kind]
            return len(hs), sum(h.nbytes for h in hs)

    def _update_gauges_locked(self) -> None:
        reg = _registry()
        reg.gauge("memgov.catalog.entries").set(len(self._entries))
        for tier in (TIER_DEVICE, TIER_HOST, TIER_DISK):
            reg.gauge(f"memgov.catalog.{tier}_bytes").set(
                self._tier_bytes_locked(tier)
            )
        arenas = [h for h in self._entries.values() if h.kind == "arena"]
        reg.gauge("memgov.arenas").set(len(arenas))
        reg.gauge("memgov.arena_bytes").set(sum(h.nbytes for h in arenas))
        cached = [h for h in self._entries.values() if h.kind == "cache"]
        reg.gauge("memgov.cache_entries").set(len(cached))
        reg.gauge("memgov.cache_bytes").set(sum(h.nbytes for h in cached))

    def snapshot(self) -> dict:
        """JSON-clean shape for the stats report."""
        with self._lock:
            arenas = [h for h in self._entries.values() if h.kind == "arena"]
            return {
                "entries": len(self._entries),
                "device_bytes": self._tier_bytes_locked(TIER_DEVICE),
                "host_bytes": self._tier_bytes_locked(TIER_HOST),
                "disk_bytes": self._tier_bytes_locked(TIER_DISK),
                "pinned_device_bytes": sum(
                    h.nbytes
                    for h in self._entries.values()
                    if h.tier == TIER_DEVICE and h._pins > 0
                ),
                "arenas": len(arenas),
                "arena_bytes": sum(h.nbytes for h in arenas),
                "cache_entries": sum(
                    1 for h in self._entries.values() if h.kind == "cache"
                ),
                "cache_bytes": sum(
                    h.nbytes
                    for h in self._entries.values()
                    if h.kind == "cache"
                ),
            }

    # -- demotion ------------------------------------------------------------

    def _resolve_spill_dir(self) -> str:
        if self._spill_dir is None:
            from ..utils import knobs

            self._spill_dir = knobs.get_str("SRJTORCH_SPILL_DIR") or os.path.join(
                tempfile.gettempdir(), f"srjtorch-spill-{os.getpid()}"
            )
        os.makedirs(self._spill_dir, exist_ok=True)
        return self._spill_dir

    def _spill_locked(self, h: SpillableHandle) -> None:
        """device -> host. Raises RetryableError when the chaos
        ``spill_fail`` rule fires (the caller skips the entry); then
        enforces the host budget by demoting LRU host entries to disk."""
        from ..utils import faultinj, metrics, tracing

        reg = _registry()
        t0 = time.perf_counter()
        with tracing.span("memgov.spill", key=h.key, nbytes=h.nbytes):
            faultinj.maybe_inject("memgov.spill")
            defs = _leaf_defs(h._treedef)
            h._host = [_to_host(t, d) for t, d in zip(h._device, defs)]
        h._device = None
        if h.spill_count:
            reg.counter("memgov.respilled").inc()
        h.spill_count += 1
        reg.counter("memgov.spills").inc()
        reg.counter("memgov.spilled_bytes").inc(h.nbytes)
        reg.histogram("memgov.spill_us").record((time.perf_counter() - t0) * 1e6)
        metrics.event("memgov.spill", key=h.key, nbytes=h.nbytes, tier=TIER_HOST)
        if self._host_budget > 0:
            try:
                self._enforce_host_budget_locked()
            except OSError:
                # the disk tier is unavailable (a full disk, a bad
                # SRJTORCH_SPILL_DIR): the host copy stands, over budget
                reg.counter("memgov.spill_failures").inc()
                metrics.event("memgov.spill_failed", key=h.key, tier=TIER_DISK)

    def _demote_disk_locked(self, h: SpillableHandle) -> None:
        """host -> disk: one columnar frame per entry under the spill
        directory, per-leaf CRCs verified on re-materialization (written
        unchecked with integrity checks off). A ``corrupt`` rule keyed
        ``memgov.spill.frame`` flips bytes after the CRCs were computed:
        the bit-rot-on-disk model."""
        from ..columnar import frames
        from ..utils import faultinj, metrics

        reg = _registry()
        t0 = time.perf_counter()
        safe = re.sub(r"[^A-Za-z0-9_.-]", "_", h.key)
        path = os.path.join(
            self._resolve_spill_dir(), f"{safe}-{h._seq}.frm"
        )
        blob = faultinj.maybe_corrupt("memgov.spill.frame",
                                      frames.encode_leaves(h._host))
        with open(path, "wb") as f:
            f.write(blob)
        h._disk_path = path
        h._host = None
        # a manifest makes the spill file survivable: a fresh process
        # re-registers it; a failed write costs that, never the demotion
        from . import persist
        if persist.manifests_enabled():
            persist.write_manifest(
                path, h.key, h.kind, h.nbytes, h._n_leaves, h._treedef
            )
        reg.counter("memgov.disk_spills").inc()
        reg.counter("memgov.disk_spilled_bytes").inc(h.nbytes)
        reg.histogram("memgov.spill_us").record((time.perf_counter() - t0) * 1e6)
        metrics.event("memgov.spill", key=h.key, nbytes=h.nbytes, tier=TIER_DISK)

    def _enforce_host_budget_locked(self) -> None:
        over = self._tier_bytes_locked(TIER_HOST) - self._host_budget
        if over <= 0:
            return
        victims = sorted(
            (
                h
                for h in self._entries.values()
                if h.tier == TIER_HOST and h._pins == 0 and h._treedef is not None
            ),
            key=lambda h: h._seq,
        )
        for h in victims:
            if over <= 0:
                break
            self._demote_disk_locked(h)
            over -= h.nbytes

    def _force_spill(self, h: SpillableHandle, to_disk: bool = False) -> None:
        with self._lock:
            if h._closed:
                raise ValueError(f"catalog entry {h.key!r} is closed")
            if h._pins > 0:
                raise ValueError(f"catalog entry {h.key!r} is pinned")
            if h._device is not None:
                self._spill_locked(h)
            if to_disk and h._host is not None:
                self._demote_disk_locked(h)
            self._update_gauges_locked()

    def spill_until(self, need_bytes: int, name: str = "pressure") -> int:
        """Demote LRU-ordered unpinned device entries until at least
        ``need_bytes`` are reclaimed (or nothing spillable remains).
        Returns the bytes freed. A failed spill skips that entry (counted
        ``memgov.spill_failures``): the pressure loop degrades, it never
        crashes the admission path."""
        from ..utils import metrics

        reg = _registry()
        freed = 0
        with self._lock:
            victims = sorted(
                (h for h in self._entries.values() if h.spillable),
                key=lambda h: h._seq,
            )
            for h in victims:
                if freed >= need_bytes:
                    break
                try:
                    self._spill_locked(h)
                except (RetryableError, OSError):
                    reg.counter("memgov.spill_failures").inc()
                    metrics.event("memgov.spill_failed", key=h.key)
                    continue
                freed += h.nbytes
            self._update_gauges_locked()
        return freed

    # -- access / re-materialization -----------------------------------------

    def _load_disk_locked(self, h: SpillableHandle) -> None:
        """disk -> host half of re-materialization: decode the frame and
        VERIFY it before trusting a byte. A mismatch (bit rot, truncation,
        a torn write) or an unreadable file retires the entry (the only
        copy is bad) and raises the retryable ``DataCorruption``, so the
        caller re-computes from its source."""
        import io

        from ..columnar import frames
        from ..utils import integrity, metrics

        path = h._disk_path
        try:
            with open(path, "rb") as f:
                raw = f.read()
            if frames.is_frame(raw):
                if integrity.is_enabled() and frames.is_checked(raw):
                    _registry().counter("sidecar.integrity.spills_checked").inc()
                h._host = frames.decode_leaves(raw, where="memgov.spill")
                if len(h._host) != h._n_leaves:
                    raise integrity.raise_corruption(
                        "memgov.spill",
                        f"{h.key}: leaf count {len(h._host)} != {h._n_leaves}",
                    )
            else:
                if raw[: len(_SPILL_MAGIC)] == _SPILL_MAGIC:
                    crc = integrity.unpack_crc(raw, len(_SPILL_MAGIC))
                    blen = int.from_bytes(
                        raw[len(_SPILL_MAGIC) + 4 : len(_SPILL_MAGIC) + 12], "little"
                    )
                    blob = raw[len(_SPILL_MAGIC) + 12 :]
                    if integrity.is_enabled():
                        _registry().counter("sidecar.integrity.spills_checked").inc()
                        if len(blob) != blen:
                            raise integrity.raise_corruption(
                                "memgov.spill", f"{h.key}: truncated ({len(blob)} != {blen})"
                            )
                        integrity.verify(blob, crc, "memgov.spill")
                else:
                    blob = raw  # a plain npz container: no trailer to check
                with np.load(io.BytesIO(blob)) as z:
                    h._host = [z[f"a{i}"] for i in range(h._n_leaves)]
        except Exception as e:
            from ..utils.errors import DataCorruption

            metrics.event("memgov.spill_corrupt", key=h.key, path=path)
            self._entries.pop(h.key, None)
            self._close_locked(h)
            self._update_gauges_locked()
            if isinstance(e, DataCorruption):
                raise
            raise integrity.raise_corruption(
                "memgov.spill", f"{h.key}: unreadable spill file ({e})"
            ) from e
        try:
            os.unlink(path)
        except OSError:
            pass
        from . import persist
        persist.remove_manifest(path)
        h._disk_path = None

    def _get(self, h: SpillableHandle):
        from ..utils import metrics

        reg = _registry()
        with self._lock:
            if h._closed:
                raise ValueError(f"catalog entry {h.key!r} is closed")
            if h._treedef is None:
                raise ValueError(
                    f"catalog entry {h.key!r} is accounting-only (no payload)"
                )
            self._seq += 1
            h._seq = self._seq  # LRU refresh
            if h._device is None:
                from ..utils import tracing

                t0 = time.perf_counter()
                with tracing.span(
                    "memgov.rematerialize", key=h.key, nbytes=h.nbytes,
                    tier=h.tier,
                ):
                    if h._disk_path is not None:
                        self._load_disk_locked(h)
                    defs = _leaf_defs(h._treedef)
                    h._device = [_to_device(a, d) for a, d in zip(h._host, defs)]
                h._host = None
                reg.counter("memgov.rematerialized").inc()
                reg.counter("memgov.rematerialized_bytes").inc(h.nbytes)
                reg.histogram("memgov.rematerialize_us").record(
                    (time.perf_counter() - t0) * 1e6
                )
                metrics.event(
                    "memgov.rematerialize", key=h.key, nbytes=h.nbytes
                )
                self._update_gauges_locked()
            return unflatten(h._treedef, h._device)
