"""The benchmark of ``spark_rapids_jni_tpu_torch``: one cell, one run.

A cell ``<config>.<mix>`` of ``BENCHMARK.json`` resolves by name to
``configs/<config>.json`` (sizes; its ``dataset`` names the generator in
``datasets/<dataset>.py``), ``mixes/<mix>.json`` (the traffic; its
``item`` names the code that runs an item, ``items/<item>.py``) and
``limits/<cell>.json`` (the limit of each number the check compares).
Each per-layer metric resolves to its reader,
``layer_metrics/<name>.py``. Adding a cell, a mix, a configuration or a
metric adds files and entries; it edits none.

A run: the inputs from the seed, two warm items, then a closed loop with
one client for ``--seconds`` (the next item issued when the last one has
synchronized), then the check of what the window produced against the
plain reference. ``--trace 0`` reports the cell's end-to-end metrics;
``--trace 1`` runs the loop with a span (a synchronize before and after)
around each stage, then traces a short stretch of items under
``torch.profiler``, and reports the per-layer metrics.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import sys
import time
import traceback
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
CACHE_DIR = ROOT / "build" / "portbench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "spark_rapids_jni_tpu")
PROGRAM = "spark_rapids_jni_tpu_torch"
SAMPLE_SALT = 0x9E3779B97F4A7C15
TORCH_THREADS = 2
WARM_ITEMS = 2  # items run in set-up, before the window
# items in the trace with host activity: a longer one comes back short of
# hand-kernel launches (3 of 30 at 5 round-trip batches, 0 of 12 at 2)
HOST_TRACE_ITEMS = 2


def process_age_s() -> float:
    """Seconds since this process started, from ``/proc`` (0 where it
    cannot be read)."""
    try:
        start_ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


def set_cache_dirs() -> None:
    """Compiler and kernel caches at fixed paths inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_compute")):
        os.environ[var] = str(CACHE_DIR / sub)


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def resolve(bench: dict, name: str, bench_dir: Path = BENCH_DIR) -> dict:
    """Everything of one cell, found by name under ``bench_dir``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    cfg = _json(bench_dir / "configs" / f"{w['config']}.json")
    mix = _json(bench_dir / "mixes" / f"{w['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e_names)]
    return {
        "name": name, "chips": w["chips"], "cfg": cfg, "mix": mix,
        "limits": _json(bench_dir / "limits" / f"{name}.json"),
        "dataset": bench_dir / "datasets" / f"{cfg['dataset']}.py",
        "item": bench_dir / "items" / f"{mix['item']}.py",
        "end_to_end": e2e, "per_layer": layer,
        "readers": {m["name"]: bench_dir / "layer_metrics" / f"{m['name']}.py" for m in layer},
    }


def sampled(seed: int, i: int, every: int) -> bool:
    """Whether item ``i`` of the window is kept for the check: one in
    about ``every``, drawn from the seed."""
    x = (seed * SAMPLE_SALT + i + 1) & (2**64 - 1)
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & (2**64 - 1)
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & (2**64 - 1)
    return (x ^ (x >> 31)) % every == 0


class Spans:
    """The stage spans an item opens. ``timed``: a synchronize before and
    after each, the host clock and CUDA events around it, by stage name.
    Untimed: a ``record_function`` range only (``labels``), or nothing."""

    def __init__(self, device, timed: bool = False, labels: bool = False):
        import torch

        self.cuda = device.type == "cuda"
        self.timed = timed
        self.labels = labels or timed
        self.host_s = {}
        self.event_s = {}
        self._torch = torch

    def sync(self) -> None:
        if self.cuda:
            self._torch.cuda.synchronize()

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.labels:
            yield
            return
        torch = self._torch
        with torch.profiler.record_function("portbench." + name):
            if not self.timed:
                yield
                return
            self.sync()
            if self.cuda:
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
            h0 = time.perf_counter()
            yield
            if self.cuda:
                e1.record()
            self.sync()
            host = time.perf_counter() - h0
            self.host_s.setdefault(name, []).append(host)
            self.event_s.setdefault(name, []).append(e0.elapsed_time(e1) / 1e3 if self.cuda else host)


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device, t0: float) -> dict:
    """One run of ``cell``: the result's fields, ``checks`` last."""
    import torch

    from portbench import arith

    torch.set_num_threads(TORCH_THREADS)
    seed = seed % 2**63
    cuda = device.type == "cuda"
    dataset, item = load_module(cell["dataset"]), load_module(cell["item"])
    cfg, mix = cell["cfg"], cell["mix"]
    st = item.prepare(cfg, mix, dataset.make(cfg, seed, device), device)
    plain = Spans(device)
    out = None
    for _ in range(WARM_ITEMS):
        out = None
        out = item.step(st, plain)
        plain.sync()
    out = None
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0

    spans = Spans(device, timed=True) if trace else plain
    latencies, ends, samples = [], [], []
    attempted = failed = n_rows = 0
    w0 = time.perf_counter()
    while time.perf_counter() - w0 < seconds:
        i = attempted
        attempted += 1
        out = None
        ti = time.perf_counter()
        try:
            out = item.step(st, spans)
            spans.sync()
        except Exception:  # an item that fails counts as failed; the loop goes on
            failed += 1
            out = None
            traceback.print_exc()
            continue
        t1 = time.perf_counter()
        latencies.append(t1 - ti)
        ends.append(t1 - w0)
        n_rows += item.rows(st)
        if sampled(seed, i, mix["sample_every"]):
            samples.append(item.sample(st, out))
            spans.sync()  # the sample's work kept out of the next item's latency
    window_s = time.perf_counter() - w0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if not latencies:
        raise RuntimeError("no item completed in the window")
    lat_ms = [x * 1e3 for x in latencies]
    print(f"window: {len(lat_ms)} items in {window_s:.3f} s; latency median "
          f"{arith.percentile(lat_ms, 50):.3f} ms, p95 {arith.percentile(lat_ms, 95):.3f} ms; "
          f"{len(samples)} sampled", file=sys.stderr, flush=True)
    for first in (True, False):  # how the host's speed moved within the window
        half = [x for x, e in zip(lat_ms, ends) if (e <= window_s / 2) == first]
        if half:
            print(f"window {'first' if first else 'second'} half: {len(half)} items, latency "
                  f"median {arith.percentile(half, 50):.3f} ms", file=sys.stderr, flush=True)

    name = torch.cuda.get_device_name(0) if cuda else "cpu"
    dev_info = {"platform": "gpu" if cuda else "cpu", "kind": name, "count": cell["chips"],
                "memory_peak_bytes": int(peak)}
    result = {"attempted": attempted, "failed": failed}
    if trace:
        metrics, breakdown = _per_layer(cell, item, st, spans, latencies, name, device, dev_info)
        result["breakdown"] = breakdown
    else:
        values = {
            "rows_per_s": arith.rate(n_rows, window_s),
            "latency_p95_ms": arith.percentile(lat_ms, 95),
            "peak_device_gib": peak / arith.GIB,
            "setup_s": setup_s,
        }
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    result["metrics"] = metrics
    result["device"] = dev_info

    # the check: the program's state freed but the last item's outputs,
    # the sampled items' and the inputs
    ans = item.answers(st, out) if out is not None else None
    out = None
    if cuda:
        torch.cuda.synchronize()
    t = time.perf_counter()
    checks = {}
    if ans is not None:
        for k, v in item.judge(st, ans, samples).items():
            checks[k] = {"value": v, "limit": cell["limits"].get(k)}
    print(f"check: {time.perf_counter() - t:.2f} s", file=sys.stderr, flush=True)
    correct = (ans is not None and failed == 0 and bool(checks)
               and all(c["limit"] is not None and c["value"] <= c["limit"] for c in checks.values()))
    return {"correct": correct, **result, "checks": checks}


def _per_layer(cell, item, st, spans, latencies, device_name, device, dev_info):
    """The per-layer metrics from the span loop and a traced stretch."""
    from portbench import trace as tr
    from spark_rapids_jni_tpu_torch.utils import tracing

    labels = Spans(device, labels=True)

    def run_items(n: int) -> None:
        for _ in range(n):
            item.step(st, labels)
            labels.sync()

    n, hand = cell["mix"]["profile_items"], tr.hand_kernel_names(ROOT / PROGRAM)
    # the busy time and device operations from a trace of the device alone:
    # host activity tracing slows the host, and the device waits for it
    dev = tr.profile_stretch(run_items, n, hand, labels.sync, host=False)
    tracing.set_enabled(True)  # the program's op ranges, in the host trace only
    try:
        prof = tr.profile_stretch(run_items, HOST_TRACE_ITEMS, hand, labels.sync, host=True)
    finally:
        tracing.set_enabled(False)
    dev_info["busy_s"] = dev["busy_s"]
    dev_info["window_s"] = dev["window_s"]
    rec = {"cfg": cell["cfg"], "mix": cell["mix"], "device_name": device_name,
           "latency_s": sum(latencies) / len(latencies),
           "host_s": spans.host_s, "event_s": spans.event_s, "profile": prof, "device": dev,
           "info": item.info(st) if hasattr(item, "info") else {}}
    metrics = {}
    for m in cell["per_layer"]:
        v = load_module(cell["readers"][m["name"]]).read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    breakdown = {"device_ops": [[k, v] for k, v in dev["device_ops"]],
                 "idle_gaps": [[k, v] for k, v in prof["idle_gaps"]]}
    return metrics, breakdown


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN)


def main(argv, t0: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = resolve(_json(ROOT / "BENCHMARK.json"), args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    import spark_rapids_jni_tpu_torch  # noqa: F401  (the program: fails where it is absent)

    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), t0)
    _card_line()
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {', '.join(bad)}: the JAX package or JAX, which no run may load",
              file=sys.stderr)
        return 3
    _print_result(res)
    return 0


def _card_line() -> None:
    """The card's name and power limit, beside the numbers."""
    import subprocess

    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=30)
        line = r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout.strip() else (
            f"nvidia-smi exited {r.returncode}")
    except (OSError, subprocess.TimeoutExpired) as e:
        line = f"nvidia-smi unavailable: {e}"
    print(f"card: {line}", file=sys.stderr, flush=True)


def _print_result(res: dict) -> None:
    for k, c in res["checks"].items():
        ok = c["limit"] is not None and c["value"] <= c["limit"]
        print(f"check {k}: {c['value']!r} limit {c['limit']!r} {'ok' if ok else 'FAILED'}",
              file=sys.stderr)
    print(f"correct: {res['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(res), flush=True)
