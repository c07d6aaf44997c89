"""The part of the JAX package's error taxonomy (``utils/errors.py``) that
the port raises: a corrupted payload is ``DataCorruption``, a retryable
device error, so a caller re-fetches or re-computes instead of returning
wrong rows. The rest of the taxonomy (fatal errors, ``classify``,
``Overloaded``, ``DeadlineExceeded``) comes with the runtime services."""

from __future__ import annotations

__all__ = ["DeviceError", "RetryableError", "DataCorruption"]


class DeviceError(RuntimeError):
    """Base for device-side failures crossing the runtime boundary."""


class RetryableError(DeviceError):
    """Transient failure; the same batch may be retried on this device."""


class DataCorruption(RetryableError):
    """A CRC-checked payload failed verification (``utils/integrity.py``):
    a frame whose bytes changed between producer and consumer. Retryable
    by design: the device and the data source are healthy, the copy is
    bad."""
