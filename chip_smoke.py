#!/usr/bin/env python3
"""Chip smoke for the PyTorch/H100 port (``spark_rapids_jni_tpu_torch``).

Builds the port's hand-written CUDA kernels from the sources in this
checkout, then on one card:

1. prints the card (``torch.cuda.get_device_name`` and nvidia-smi's name
   and power limit);
2. holds each kernel of the main path against its plain PyTorch version
   at the shapes the main path gives it, and times the kernel, the plain
   version and one library call computing the same function (CUDA
   events, warm-up, then the median of 10 launches);
3. drives the main path once at full size -- 1,000,000 rows x 212
   fixed-width columns (an INT64 key in [0, 4096), a FLOAT32 value and
   210 columns cycling the nine integer types of the reference's
   ``row_conversion_fixed`` benchmark, validity on every third of them,
   792 bytes a row) through ``convert_to_rows`` -> ``convert_from_rows``
   -> ``groupby_sum_bounded(key, value, 4096)`` -- with every launch
   counter set to 0 just before and read just after, and checks the
   result against a numpy oracle on the host;
4. prints one ``{"kernels": [...]}`` line and, last, the
   ``{"ok": true, "device": {...}}`` line.

Any failed check raises and the script exits non-zero. Without a card,
or run from a directory without the port package, it exits non-zero
before printing any result.

Usage: ``python3 chip_smoke.py`` from the root of the checkout.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

ROWS = 1_000_000
NUM_KEYS = 4096
SEED = 20261016
REPS = 10
# float32 sums: the reference's own bound for its group-by kernel; the
# kernel's atomics add in an order that changes from run to run
RTOL, ATOL = 2e-6, 1e-3
ORACLE_ROWS = 4096  # rows of the blob held against a numpy row encoder


def _mem_rate(name: str) -> float:
    """Published device-memory rate (NVIDIA data sheets), bytes/s."""
    return 4.8e12 if "H200" in name else 3.35e12  # else H100 SXM


def _time_ms(fn, reps: int = REPS, warm: int = 2) -> float:
    """Median device time of one call, by CUDA events around each call."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _host_ms(fn, reps: int = 3):
    """Median host time (ms) of ``fn`` ending in a device synchronize."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


# ---------------------------------------------------------------------------
# input
# ---------------------------------------------------------------------------


def _schema(pdt):
    nine = [pdt.INT8, pdt.INT16, pdt.INT32, pdt.INT64,
            pdt.UINT8, pdt.UINT16, pdt.UINT32, pdt.UINT64, pdt.BOOL8]
    return [pdt.INT64, pdt.FLOAT32] + [nine[i % 9] for i in range(210)]


def _host_table(dtypes, rows: int, seed: int):
    """Seeded storage arrays and validity masks (None = no nulls)."""
    from spark_rapids_jni_tpu_torch.columnar.dtype import TypeId

    rng = np.random.default_rng(seed)
    arrays, valids = [], []
    for i, d in enumerate(dtypes):
        if i == 0:
            a = rng.integers(0, NUM_KEYS, rows, dtype=np.int64)
        elif i == 1:
            a = rng.standard_normal(rows, dtype=np.float32)
        elif d.id == TypeId.BOOL8:
            a = rng.integers(0, 2, rows, dtype=np.uint8)
        else:
            info = np.iinfo(d.np_dtype)
            a = rng.integers(info.min, info.max, rows, dtype=d.np_dtype, endpoint=True)
        arrays.append(a)
        valids.append(rng.random(rows) < 0.9 if i >= 2 and (i - 2) % 3 == 0 else None)
    return arrays, valids


def _oracle_rows(layout, arrays, valids, rows: int) -> np.ndarray:
    """JCUDF rows of the first ``rows`` rows, placed byte by byte in numpy."""
    out = np.zeros((rows, layout.row_size_fixed), np.uint8)
    for i, a in enumerate(arrays):
        by = np.ascontiguousarray(a[:rows]).view(np.uint8).reshape(rows, -1)
        s = layout.col_starts[i]
        out[:, s : s + by.shape[1]] = by
        v = np.ones(rows, bool) if valids[i] is None else valids[i][:rows]
        out[:, layout.validity_offset + i // 8] |= v.astype(np.uint8) << (i % 8)
    return out


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def _device_phase():
    import torch

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    smi_line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else (
        f"nvidia-smi unavailable (rc {smi.returncode})")
    print(f"device: {name}; count {torch.cuda.device_count()}", flush=True)
    print(smi_line, flush=True)
    return name, smi_line


def _build_phase():
    from spark_rapids_jni_tpu_torch import _build

    t0 = time.perf_counter()
    _build.build_all()
    for name in _build.SOURCES:
        _build.library(name)
    print(f"build: {len(_build.SOURCES)} kernel libraries in {time.perf_counter() - t0:.1f} s "
          f"({_build.BUILD_DIR})", flush=True)


def _kernel_phase(table, layout, rate: float):
    """Each kernel against its plain version at the main path's shapes."""
    import torch
    from spark_rapids_jni_tpu_torch.ops import hopper_kernels as hk
    from spark_rapids_jni_tpu_torch.ops import ragged_bytes as rb
    from spark_rapids_jni_tpu_torch.ops import row_conversion as rc

    results = {}

    # B6: the encode's word planes [P, N] -> byte planes [4P, N]
    planes = rc._fixed_planes32(layout, table.columns, layout.row_size_fixed)
    p, n = planes.shape
    got = rb.expand_u32_planes(planes)
    want = rb.expand_u32_planes_plain(planes)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("expand_u32_planes disagrees with its plain version")
    nbytes = 8 * p * n
    results["expand_u32_planes"] = dict(
        max_abs_err=0.0,
        ms=_time_ms(lambda: rb.expand_u32_planes(planes)),
        plain_ms=_time_ms(lambda: rb.expand_u32_planes_plain(planes)),
        library_ms=_time_ms(
            lambda: planes.view(torch.uint8).view(p, n, 4).permute(0, 2, 1).contiguous()),
        bound_ms=nbytes / rate * 1e3, bound_by="bytes", shape=f"int32 [{p}, {n}] -> uint8 [{4 * p}, {n}]",
    )
    del got

    # B7: the decode's byte planes [4P, N] (the transposed row blob) -> words
    bplanes = want
    got = rb.pack_u8_planes(bplanes)
    want = rb.pack_u8_planes_plain(bplanes)
    torch.cuda.synchronize()
    if not (torch.equal(got, want) and torch.equal(got, planes)):
        raise AssertionError("pack_u8_planes disagrees with its plain version")
    results["pack_u8_planes"] = dict(
        max_abs_err=0.0,
        ms=_time_ms(lambda: rb.pack_u8_planes(bplanes)),
        plain_ms=_time_ms(lambda: rb.pack_u8_planes_plain(bplanes)),
        library_ms=_time_ms(
            lambda: bplanes.view(p, 4, n).permute(0, 2, 1).contiguous().view(torch.int32)),
        bound_ms=nbytes / rate * 1e3, bound_by="bytes", shape=f"uint8 [{4 * p}, {n}] -> int32 [{p}, {n}]",
    )
    del got, want, bplanes, planes

    # B3: group-by over the key and value columns
    keys, vals = table.columns[0].data, table.columns[1].data
    gs, gc = hk.groupby_sum_outer(keys, vals, NUM_KEYS)
    ws, wc = hk.groupby_sum_outer_plain(keys, vals, NUM_KEYS)
    torch.cuda.synchronize()
    if not torch.equal(gc, wc):
        raise AssertionError("groupby_sum_outer counts disagree with its plain version")
    if not torch.allclose(gs, ws, rtol=RTOL, atol=ATOL):
        raise AssertionError("groupby_sum_outer sums disagree with its plain version")

    def library():
        s = torch.zeros(NUM_KEYS, dtype=torch.float32, device=keys.device).index_add_(0, keys, vals)
        return s, torch.bincount(keys, minlength=NUM_KEYS)

    n = keys.shape[0]
    results["groupby_sum_outer"] = dict(
        max_abs_err=float((gs - ws).abs().max()),
        ms=_time_ms(lambda: hk.groupby_sum_outer(keys, vals, NUM_KEYS)),
        plain_ms=_time_ms(lambda: hk.groupby_sum_outer_plain(keys, vals, NUM_KEYS)),
        library_ms=_time_ms(library),
        # reads 12 B a row (int64 key, f32 value), writes 12 B a key
        # (f32 sum, int64 count); one add a row is far below the f32 rate
        bound_ms=(12 * n + 12 * NUM_KEYS) / rate * 1e3, bound_by="bytes",
        shape=f"int64 [{n}] keys, float32 [{n}] values, K={NUM_KEYS}",
    )
    return results


def _profile_phase(run_path, top: int = 8):
    """One warm main-path run under torch.profiler: device busy time by
    kernel and by aten op, and the device's idle share of the host window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run_path()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_path()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_kernel = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        us, cnt = by_kernel.get(e.name, (0.0, 0))
        by_kernel[e.name] = (us + e.time_range.elapsed_us(), cnt + 1)
    if not spans:
        print("profile: the profiler recorded no device time (not measured)", flush=True)
        return None
    busy_us, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            busy_us += e - max(s, end)
            end = e
    ops = sorted(
        ((a.key, a.device_time_total, a.count) for a in prof.key_averages()
         if a.device_type == DeviceType.CPU and a.key.startswith("aten::") and a.device_time_total > 0),
        key=lambda x: -x[1])
    print(f"profile: device busy {busy_us / 1e3:.2f} ms of a {wall_ms:.2f} ms host window "
          f"(idle share {1 - busy_us / 1e3 / wall_ms:.3f}), {len(spans)} kernel launches", flush=True)
    for name, (us, cnt) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"profile kernel: {us / 1e3:9.3f} ms x{cnt:<4d} {name[:110]}", flush=True)
    for name, us, cnt in ops[:top]:
        print(f"profile op (incl. children): {us / 1e3:9.3f} ms x{cnt:<4d} {name}", flush=True)
    return {"device_busy_ms": busy_us / 1e3, "host_window_ms": wall_ms,
            "idle_share": 1 - busy_us / 1e3 / wall_ms, "kernel_launches": len(spans)}


def _main_path(table, dtypes):
    """convert_to_rows -> convert_from_rows -> groupby_sum_bounded, once."""
    import torch
    from spark_rapids_jni_tpu_torch.ops import aggregate, row_conversion as rc

    stage = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = rc.convert_to_rows(table)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    decoded = [rc.convert_from_rows(b, dtypes) for b in rows]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if len(decoded) != 1:
        raise AssertionError(f"expected one row batch, got {len(decoded)}")
    dec = decoded[0]
    sums, counts = aggregate.groupby_sum_bounded(dec.columns[0].data, dec.columns[1].data, NUM_KEYS)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    stage["encode_ms"] = (t1 - t0) * 1e3
    stage["decode_ms"] = (t2 - t1) * 1e3
    stage["groupby_ms"] = (t3 - t2) * 1e3
    stage["end_to_end_ms"] = (t3 - t0) * 1e3
    return rows, dec, sums, counts, stage


def _check_main_path(layout, arrays, valids, rows, dec, sums, counts):
    if len(rows) != 1 or len(rows[0]) != ROWS:
        raise AssertionError("row batch count or length is wrong")
    blob = rows[0].child.data[: ORACLE_ROWS * layout.row_size_fixed].cpu().numpy().view(np.uint8)
    want = _oracle_rows(layout, arrays, valids, ORACLE_ROWS).reshape(-1)
    if not np.array_equal(blob, want):
        bad = int(np.flatnonzero(blob != want)[0])
        raise AssertionError(f"row blob differs from the numpy encoder at byte {bad}")
    offs = rows[0].offsets.cpu().numpy()
    if not np.array_equal(offs, np.arange(ROWS + 1, dtype=np.int64) * layout.row_size_fixed):
        raise AssertionError("row offsets are not the uniform stride")
    for i, (col, a, v) in enumerate(zip(dec.columns, arrays, valids)):
        got = col.to_numpy()
        if got.dtype != a.dtype or not np.array_equal(got.view(np.uint8), a.view(np.uint8)):
            raise AssertionError(f"decoded column {i} differs from the input bits")
        vm = col.valid_mask().cpu().numpy()
        if not np.array_equal(vm, np.ones(ROWS, bool) if v is None else v):
            raise AssertionError(f"decoded validity of column {i} differs")
    keys, vals = arrays[0], arrays[1]
    want_c = np.bincount(keys, minlength=NUM_KEYS)
    want_s = np.bincount(keys, weights=vals.astype(np.float64), minlength=NUM_KEYS)
    got_s, got_c = sums.cpu().numpy(), counts.cpu().numpy()
    if not np.array_equal(got_c, want_c):
        raise AssertionError("group-by counts differ from np.bincount")
    if not np.allclose(got_s, want_s, rtol=RTOL, atol=ATOL):
        raise AssertionError("group-by sums outside rtol 2e-6 / atol 1e-3 of the float64 oracle")
    return float(np.max(np.abs(got_s - want_s)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs only on a card",
              file=sys.stderr)
        return 2
    try:
        from spark_rapids_jni_tpu_torch.columnar import Table
        from spark_rapids_jni_tpu_torch.columnar import dtype as pdt
        from spark_rapids_jni_tpu_torch.ops import aggregate
        from spark_rapids_jni_tpu_torch.ops import hopper_kernels as hk
        from spark_rapids_jni_tpu_torch.ops import ragged_bytes as rb
        from spark_rapids_jni_tpu_torch.ops import row_conversion as rc
    except ImportError as e:
        print(f"chip_smoke: the port package is not importable here: {e}", file=sys.stderr)
        return 2

    name, smi_line = _device_phase()
    _build_phase()

    dtypes = _schema(pdt)
    layout = rc.compute_row_layout(dtypes)
    t0 = time.perf_counter()
    arrays, valids = _host_table(dtypes, ROWS, SEED)
    table = Table.from_numpy(arrays, dtypes, valids, device="cuda")
    torch.cuda.synchronize()
    print(f"input: {ROWS} rows x {len(dtypes)} columns, {layout.row_size_fixed} B a row, "
          f"made and uploaded in {time.perf_counter() - t0:.1f} s", flush=True)

    rate = _mem_rate(name)
    kernels = _kernel_phase(table, layout, rate)
    for k, r in kernels.items():
        print(f"kernel {k} [{r['shape']}]: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
              f"library {r['library_ms']:.4f}, bound {r['bound_ms']:.4f} by {r['bound_by']}), "
              f"max abs err {r['max_abs_err']}", flush=True)

    wrappers = {"expand_u32_planes": rb.expand_u32_planes, "pack_u8_planes": rb.pack_u8_planes,
                "groupby_sum_outer": hk.groupby_sum_outer}
    for w in wrappers.values():
        w.launches = 0
    rows, dec, sums, counts, stage = _main_path(table, dtypes)
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f"main path launches: {launches}", flush=True)
    for k, c in launches.items():
        if c < 1:
            raise AssertionError(f"the main path never launched {k}")
    sum_err = _check_main_path(layout, arrays, valids, rows, dec, sums, counts)
    print(f"main path checked against the numpy oracle: rows bit-identical on the first "
          f"{ORACLE_ROWS} rows, {len(dtypes)} decoded columns bit-identical, counts exact, "
          f"sums max abs err {sum_err:.3g} vs float64", flush=True)
    del rows, dec

    def run_path():
        r = rc.convert_to_rows(table)
        d = rc.convert_from_rows(r[0], dtypes)
        aggregate.groupby_sum_bounded(d.columns[0].data, d.columns[1].data, NUM_KEYS)

    warm_ms = _host_ms(run_path)
    print(f"main path (first run, host clock): " + ", ".join(f"{k} {v:.2f}" for k, v in stage.items())
          + f"; warm end-to-end median of 3: {warm_ms:.2f} ms; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    profile = _profile_phase(run_path)

    sources = {"expand_u32_planes": "spark_rapids_jni_tpu_torch/csrc/planes.cu",
               "pack_u8_planes": "spark_rapids_jni_tpu_torch/csrc/planes.cu",
               "groupby_sum_outer": "spark_rapids_jni_tpu_torch/csrc/groupby.cu"}
    replaces = {"expand_u32_planes": "spark_rapids_jni_tpu/ops/ragged_bytes.py:185",
                "pack_u8_planes": "spark_rapids_jni_tpu/ops/ragged_bytes.py:208",
                "groupby_sum_outer": "spark_rapids_jni_tpu/ops/pallas_kernels.py:416"}
    line = {"kernels": [
        {"name": k, "route": "cuda", "source": sources[k], "replaces": replaces[k],
         "launches": launches[k], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "kernel_ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        for k, r in kernels.items()
    ], "main_path": {**stage, "warm_end_to_end_ms": warm_ms, "rows": ROWS,
                     "columns": len(dtypes), "row_bytes": layout.row_size_fixed,
                     "profile": profile},
        "card": smi_line}
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                            "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
