"""The benchmark's metric arithmetic: percentiles, rates, the
published peaks of the cards and roofline shares, the union of device
activity. Nothing here reads the program."""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

GIB = float(1 << 30)

# published device-memory rates (NVIDIA data sheets), bytes/s, by a part of
# the name torch.cuda.get_device_name() gives; the first match wins
PEAK_BYTES_PER_S = (
    ("H200", 4.8e12),
    ("H100 NVL", 3.9e12),
    ("H100 PCIe", 2.0e12),
    ("H100", 3.35e12),  # SXM, "NVIDIA H100 80GB HBM3"
)


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation between the
    closest ranks (``statistics.quantiles``' inclusive method)."""
    if not values:
        raise ValueError("no values")
    s = sorted(values)
    pos = (len(s) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def rate(amount: float, seconds: float) -> float:
    if seconds <= 0:
        raise ValueError("a rate needs a positive time")
    return amount / seconds


def peak_bytes_per_s(device_name: str) -> Optional[float]:
    for part, peak in PEAK_BYTES_PER_S:
        if part in device_name:
            return peak
    return None


def roofline_pct(nbytes: float, seconds: float, device_name: str) -> Optional[float]:
    """The least time ``nbytes`` take at the card's published memory rate,
    as a percentage of ``seconds``; None where the card or the time is
    unknown."""
    peak = peak_bytes_per_s(device_name)
    if peak is None or seconds <= 0:
        return None
    return 100.0 * nbytes / peak / seconds


def merge(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of [start, end) intervals, as sorted disjoint intervals."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def gaps(busy: Sequence[Tuple[float, float]], start: float, end: float
         ) -> List[Tuple[float, float]]:
    """The stretches of [start, end) that merged ``busy`` intervals leave."""
    out, t = [], start
    for s, e in busy:
        if s > t:
            out.append((t, min(s, end)))
        t = max(t, e)
        if t >= end:
            break
    if t < end:
        out.append((t, end))
    return [(s, e) for s, e in out if e > s]
