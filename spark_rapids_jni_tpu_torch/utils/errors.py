"""Error classification, fatal against retryable (port of the JAX
package's ``utils/errors.py``).

A device or client that is unusable is ``FatalDeviceError`` (the executor
must be replaced); anything transient is ``RetryableError`` (Spark's task
retry re-runs the batch). A corrupted payload is ``DataCorruption``, a
retryable error, so a caller re-fetches or re-computes instead of
returning wrong rows. ``classify`` maps an arbitrary backend exception
onto the taxonomy; torch's "CUDA out of memory" is the counterpart of
XLA's RESOURCE_EXHAUSTED and is retryable.
"""

from __future__ import annotations

import re

__all__ = [
    "DeviceError",
    "FatalDeviceError",
    "RetryableError",
    "DataCorruption",
    "DeadlineExceeded",
    "Overloaded",
    "classify",
]


class DeviceError(RuntimeError):
    """Base for device-side failures crossing the runtime boundary."""


class FatalDeviceError(DeviceError):
    """The device or client is unusable; the executor must be torn down."""


class RetryableError(DeviceError):
    """Transient failure; the same batch may be retried on this device."""


class DataCorruption(RetryableError):
    """A checked payload failed verification (``utils/integrity.py``): a
    frame or a shuffle exchange whose bytes changed between producer and
    consumer. Retryable by design: the device and the data source are
    healthy, the copy is bad."""


class Overloaded(RetryableError):
    """The serving runtime refused to admit work (a full queue, shedding
    under pressure, a deadline dead on arrival, shutdown). Retryable: the
    system is healthy, just saturated. ``retry_after_s`` is a backoff hint
    (never a promise); ``cause`` names the shed reason."""

    def __init__(self, message: str = "overloaded",
                 retry_after_s=None, cause: str = "overload"):
        super().__init__(message)
        self.retry_after_s = (
            None if retry_after_s is None else float(retry_after_s)
        )
        self.cause = str(cause)


class DeadlineExceeded(DeviceError):
    """The query's deadline budget is exhausted, or its cancel token
    tripped. Not retryable (a retry cannot make time) and not fatal (the
    device is healthy)."""


# Patterns in backend error text that mark a dead device or client.
# "DEAD" is word-bounded so that it cannot swallow DEADLINE_EXCEEDED (a
# retryable timeout): the fatal patterns are checked first.
_FATAL_MARKERS = (
    r"\bDEAD\b",
    "device is in an invalid state",
    "client has been shut down",
    "deadlock",
    "halted",
    "INTERNAL: Accelerator",
)

_RETRYABLE_MARKERS = (
    "RESOURCE_EXHAUSTED",
    "CUDA out of memory",  # torch's allocator OOM: RESOURCE_EXHAUSTED's counterpart
    "UNAVAILABLE",
    "DEADLINE_EXCEEDED",
    "Socket closed",
    "transient",
    # transport faults: a refused or reset connection means the peer died
    # or restarts; the task retries. Not "timed out", which a wedged
    # collective's error carries, where the fatal classification must win.
    "Connection refused",
    "Connection reset",
    "Broken pipe",
    # a stringified DataCorruption crossing a process boundary stays
    # retryable
    "CRC mismatch",
    # a stringified Overloaded stays retryable
    "Overloaded",
)


def classify(exc: BaseException) -> DeviceError:
    """Map an arbitrary backend exception onto the fatal/retryable taxonomy
    (conservative: unknown errors are fatal). Host-side input errors
    (ValueError, TypeError, KeyError, IndexError) are re-raised unchanged."""
    if isinstance(exc, DeviceError):
        return exc
    text = str(exc)
    # fatal first: a message with both kinds of marker means the device is
    # gone, and retrying batches on it would strand the executor
    for m in _FATAL_MARKERS:
        if re.search(m, text):
            return FatalDeviceError(text)
    for m in _RETRYABLE_MARKERS:
        if m in text:
            return RetryableError(text)
    if isinstance(exc, (ValueError, TypeError, KeyError, IndexError)):
        raise exc
    return FatalDeviceError(text)
