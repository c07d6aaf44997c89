"""Table generation stamps (port of the JAX package's ``cache/tablegen.py``).

Cached results are only reusable while the data they were computed
from is unchanged. The subresult cache keys on a *generation stamp*
per bound table: a ``(serial, generation)`` pair where ``serial`` is a
process-unique number assigned the first time a Table object is seen
(identity — a DIFFERENT table object gets a different serial, so a
fresh load never aliases a cached result computed over the old one)
and ``generation`` is a bump counter for in-place mutation (the repo's
tables are immutable pytrees, but ``bump()`` is the explicit
invalidation hook callers use when they rebind a name to updated
content they consider "the same table").

Serials live in a WeakKeyDictionary — a dropped table releases its
record, and because the serial (not ``id()``) goes into cache keys,
CPython's id reuse after GC can never resurrect a stale entry.
"""

from __future__ import annotations

import threading
import weakref
from typing import Tuple

__all__ = ["stamp", "bump", "reset"]

_lock = threading.Lock()
_records: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_next_serial = 0


def stamp(table) -> Tuple[int, int]:
    """The (serial, generation) stamp of one table object, assigning a
    fresh serial on first sight."""
    global _next_serial
    with _lock:
        rec = _records.get(table)
        if rec is None:
            _next_serial += 1
            rec = [_next_serial, 0]
            _records[table] = rec
        return (rec[0], rec[1])


def bump(table) -> Tuple[int, int]:
    """Advance the table's generation — every cache key derived from
    the old stamp becomes unreachable. Returns the new stamp."""
    global _next_serial
    with _lock:
        rec = _records.get(table)
        if rec is None:
            _next_serial += 1
            rec = [_next_serial, 0]
            _records[table] = rec
        rec[1] += 1
        return (rec[0], rec[1])


def reset() -> None:
    """Test hook: drop every record (fresh serials from here on)."""
    with _lock:
        _records.clear()
