"""The traced stretches of a ``--trace 1`` run: a few items under
``torch.profiler``, reduced to what the per-layer readers and the
``breakdown`` need. One trace holds the device's activity alone (the
idle share, the device operations); a second holds the host's too (the
device time under each host range, the idle gaps by range), since
tracing the host slows it, and the device waits for the host.

The profiler has come back short of launches of the program's hand
kernels (launched through ctypes), and on occasion with no device
activity at all. So each stretch is held against the program's own
launch counters (``<wrapper>.launches`` in ``ops/hopper_kernels`` and
``ops/ragged_bytes``): a trace that holds fewer hand-kernel launches than
the counters moved, or no device activity, is taken again, up to
``RETAKES`` times, and the shortfall is printed. A stretch still short
after that fails the run: its busy time and device operations would
read low.
"""

from __future__ import annotations

import re
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, List, Optional

from portbench import arith

RETAKES = 5
STRETCH = "portbench.stretch"
_PROFILER_STEP = "ProfilerStep"
TOP = 10
_NAME_CHARS = 96
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*[(<]")


def hand_kernel_names(pkg_dir: Path) -> set:
    """The names of the ``__global__`` functions in the program's CUDA
    sources."""
    names = set()
    for src in sorted((pkg_dir / "csrc").glob("*.cu*")):
        names.update(_GLOBAL.findall(src.read_text()))
    return names


def launch_counts() -> Dict[str, int]:
    """Every hand-kernel wrapper's launch counter, by wrapper name."""
    from spark_rapids_jni_tpu_torch.ops import hopper_kernels, ragged_bytes

    out = {}
    for mod in (hopper_kernels, ragged_bytes):
        for name, fn in vars(mod).items():
            n = getattr(fn, "launches", None)
            if callable(fn) and isinstance(n, int):
                out[f"{mod.__name__.rsplit('.', 1)[-1]}.{name}"] = n
    return out


def _base(kernel_name: str) -> str:
    """A device kernel's function name, without its return type,
    namespaces, template arguments and parameters."""
    head = kernel_name.replace("(anonymous namespace)::", "")
    head = head.split("(", 1)[0].split("<", 1)[0].strip()
    return head.split()[-1].rsplit("::", 1)[-1] if head else head


def _short(kernel_name: str) -> str:
    """A device operation's name without the namespaces that every torch
    kernel repeats, cut to ``_NAME_CHARS``."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::", "at::"):
        kernel_name = kernel_name.replace(noise, "")
    return kernel_name[:_NAME_CHARS]


def _reduce(events, hand: set, window_s: float) -> Optional[dict]:
    """One trace's events -> the stretch's numbers, or None when it holds
    no device activity. With host activity in the trace, the stretch is
    its ``portbench.stretch`` range on the profiler's clock, and the
    device time under each host range and the idle gaps by range are
    read too; without, it is the stretch's ``window_s`` on the host
    clock."""
    from torch.autograd import DeviceType

    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    annot = {e.name for e in cpu if e.is_user_annotation}
    dev = [e for e in events
           if e.device_type == DeviceType.CUDA and not e.is_user_annotation
           and e.name not in annot and "spin_kernel" not in e.name]
    stretch = [e for e in cpu if e.name == STRETCH]
    if stretch:
        t0, t1 = stretch[0].time_range.start, stretch[0].time_range.end
        dev = [e for e in dev if e.time_range.end > t0 and e.time_range.start < t1]
        window_s = (t1 - t0) / 1e6
    if not dev:
        return None
    if not stretch:
        t0 = min(e.time_range.start for e in dev)
        t1 = t0 + window_s * 1e6
    busy = arith.merge((max(e.time_range.start, t0), min(e.time_range.end, t1)) for e in dev)
    ops = defaultdict(float)
    for e in dev:
        ops[_short(e.name)] += e.time_range.elapsed_us() / 1e6
    red = {
        "window_s": window_s,
        "busy_s": sum(e - s for s, e in busy) / 1e6,
        "device_s": sum(e.time_range.elapsed_us() for e in dev) / 1e6,
        "hand_launches": sum(1 for e in dev if _base(e.name) in hand),
        "device_ops": sorted(ops.items(), key=lambda kv: -kv[1])[:TOP],
    }
    if not stretch:
        return red
    # device time under each range, counting each range once where it nests in itself
    under = defaultdict(float)
    for e in cpu:
        if not e.is_user_annotation or e.name == STRETCH:
            continue
        p = e.cpu_parent
        while p is not None and p.name != e.name:
            p = p.cpu_parent
        if p is None:
            under[e.name] += e.device_time_total / 1e6
    # each idle gap is named by the innermost range the host was in at its
    # midpoint (at its start the host has often not yet entered the range
    # whose host work holds the device idle)
    ranges = sorted((e for e in cpu if e.is_user_annotation and e.name != STRETCH
                     and not e.name.startswith(_PROFILER_STEP)), key=lambda e: e.time_range.start)
    idle = defaultdict(float)
    longest = []
    for gs, ge in arith.gaps(busy, t0, t1):
        mid = (gs + ge) / 2
        inner = STRETCH
        for e in ranges:
            if e.time_range.start > mid:
                break
            if e.time_range.end >= mid:
                inner = e.name
        idle[inner] += (ge - gs) / 1e6
        longest.append(((ge - gs) / 1e3, (gs - t0) / 1e3, inner))
    red.update(range_device_s=dict(under),
               idle_gaps=sorted(idle.items(), key=lambda kv: -kv[1])[:TOP],
               longest_gaps=sorted(longest, reverse=True)[:5])
    return red


def profile_stretch(run_items: Callable[[int], None], n: int, hand: set, sync: Callable[[], None],
                    host: bool) -> dict:
    """Trace ``run_items(n)`` (``n`` items, each ending in a synchronize)
    under ``torch.profiler``, with host activity (``host``) or the
    device's alone, retaking a short or empty trace. One item runs first
    in the profiler's warm-up step, so that the tracer's start-up and each
    kernel's first traced launch fall outside the stretch. Returns the
    reduced stretch with ``items``, ``traces`` and ``shortfall``."""
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host else [ProfilerActivity.CUDA]
    got: List = []
    for attempt in range(1, RETAKES + 1):
        got.clear()
        with profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: got.append(p.events())) as prof:
            run_items(1)
            prof.step()
            before = launch_counts()
            h0 = time.perf_counter()
            with record_function(STRETCH):
                run_items(n)
                sync()
            window_s = time.perf_counter() - h0
            after = launch_counts()
            prof.step()
        counted = sum(after[k] - before.get(k, 0) for k in after)
        t = time.perf_counter()
        red = _reduce(got[0], hand, window_s) if got else None
        reduce_s = time.perf_counter() - t
        traced = red["hand_launches"] if red else 0
        shortfall = max(counted - traced, 0)
        print(f"trace {attempt} ({'host and device' if host else 'device'}): {n} items, "
              f"hand-kernel launches counted {counted}, traced {traced}, shortfall {shortfall}; "
              f"device activity {'none' if red is None else 'recorded'}; read in {reduce_s:.2f} s",
              file=sys.stderr, flush=True)
        for ms, at, name in (red or {}).get("longest_gaps", []):
            print(f"  idle gap {ms:.3f} ms at {at:.3f} ms into the stretch, host in {name}",
                  file=sys.stderr, flush=True)
        if red is not None and shortfall == 0:
            break
    if red is None:
        raise RuntimeError("the profiler recorded no device activity in the stretch")
    if shortfall:
        raise RuntimeError(f"the profiler's trace is short of {shortfall} hand-kernel launches "
                           f"after {attempt} takes")
    red.update(items=n, traces=attempt, shortfall=shortfall)
    return red
