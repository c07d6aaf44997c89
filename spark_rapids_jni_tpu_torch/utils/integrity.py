"""CRC contract of the port's checked payloads (port of the JAX package's
``utils/integrity.py``): the columnar frames of ``columnar/frames.py``
carry a header CRC and one CRC per part, drawn from and verified through
this module.

Checksum algorithm: CRC-32C (Castagnoli) through the optional ``crc32c``
module when it imports, else zlib's CRC-32, the reference's rule. The
choice is made once per process, and the frame carries no algorithm id,
so the producer and the consumer of a frame must resolve the same one:
``checksum_name()`` says which.

The gate (``enable`` / ``disable`` / ``is_enabled`` and the ``enabled()``
/ ``disabled()`` context managers) starts from the knob
``SRJTORCH_INTEGRITY_CHECKS`` (on by default, as the reference's is).
While it is off, frames go out without CRCs, decodes verify nothing and
exchanges skip their checksum. Every mismatch counts registry-direct
under ``sidecar.integrity.crc_mismatch`` and
``sidecar.integrity.crc_mismatch.<where>`` (the reference's names);
``stats_section()`` reports them with the checked-decode and
checked-exchange tallies.
"""

from __future__ import annotations

import contextlib
import struct
import zlib

from . import knobs
from .errors import DataCorruption

__all__ = [
    "checksum",
    "checksum_name",
    "verify",
    "raise_corruption",
    "enable",
    "disable",
    "is_enabled",
    "enabled",
    "disabled",
    "CRC_LEN",
    "pack_crc",
    "unpack_crc",
    "stats_section",
]

CRC_LEN = 4  # the trailer is one little-endian u32, whatever the implementation

try:  # optional accelerator: real CRC-32C when the module is present
    import crc32c as _crc32c_mod

    def _crc(data, value: int = 0) -> int:
        return _crc32c_mod.crc32c(data, value)

    _CRC_NAME = "crc32c"
except ImportError:  # zlib's C implementation: the same 32-bit contract

    def _crc(data, value: int = 0) -> int:
        return zlib.crc32(data, value)

    _CRC_NAME = "crc32-zlib"


def checksum(data, value: int = 0) -> int:
    """32-bit CRC of ``data`` (bytes-like); chainable through ``value``."""
    return _crc(data, value) & 0xFFFFFFFF


def checksum_name() -> str:
    """Which implementation this process resolved."""
    return _CRC_NAME


def pack_crc(crc: int) -> bytes:
    return struct.pack("<I", crc & 0xFFFFFFFF)


def unpack_crc(raw: bytes, offset: int = 0) -> int:
    return struct.unpack_from("<I", raw, offset)[0]


_enabled = knobs.get_bool("SRJTORCH_INTEGRITY_CHECKS")


def enable() -> None:
    global _enabled
    _enabled = knobs.get_bool("SRJTORCH_INTEGRITY_CHECKS")


def disable() -> None:
    global _enabled
    _enabled = False


def is_enabled() -> bool:
    return _enabled


@contextlib.contextmanager
def enabled():
    global _enabled
    prev = _enabled
    _enabled = knobs.get_bool("SRJTORCH_INTEGRITY_CHECKS")
    try:
        yield
    finally:
        _enabled = prev


@contextlib.contextmanager
def disabled():
    global _enabled
    prev = _enabled
    _enabled = False
    try:
        yield
    finally:
        _enabled = prev


def raise_corruption(where: str, detail: str = "") -> DataCorruption:
    """Count a CRC mismatch (total + per-surface) and return the
    DataCorruption to raise (``raise raise_corruption(...)``, so the
    counter cannot drift from the error), with the reference's message."""
    from . import metrics

    reg = metrics.registry()
    reg.counter("sidecar.integrity.crc_mismatch").inc()
    reg.counter(f"sidecar.integrity.crc_mismatch.{where}").inc()
    metrics.event("integrity.crc_mismatch", where=where, detail=detail)
    return DataCorruption(
        f"CRC mismatch in {where}{f' ({detail})' if detail else ''} — "
        "payload corrupted in flight or at rest; re-fetch required"
    )


def verify(data, expected_crc: int, where: str) -> None:
    """Check ``data`` against the expected 32-bit CRC; a mismatch raises
    DataCorruption. No-op while the gate is off."""
    if not _enabled:
        return
    got = checksum(data)
    if got != (expected_crc & 0xFFFFFFFF):
        raise raise_corruption(
            where, f"expected 0x{expected_crc & 0xFFFFFFFF:08x}, got 0x{got:08x}"
        )


def stats_section() -> dict:
    """The ``integrity`` section of a stats report."""
    from . import metrics

    reg = metrics.registry()
    return {
        "enabled": _enabled,
        "algorithm": _CRC_NAME,
        "crc_mismatch": reg.value("sidecar.integrity.crc_mismatch"),
        "frames_checked": reg.value("sidecar.integrity.frames_checked"),
        "spills_checked": reg.value("sidecar.integrity.spills_checked"),
        "exchanges_checked": reg.value("sidecar.integrity.exchanges_checked"),
        "frame_decodes_checked": reg.value(
            "sidecar.integrity.frame_decodes_checked"
        ),
    }
