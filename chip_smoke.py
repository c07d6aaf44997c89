#!/usr/bin/env python3
"""Chip smoke for the PyTorch/H100 port (``spark_rapids_jni_tpu_torch``).

Builds the port's hand-written CUDA kernels from the sources in this
checkout (one nvcc per source, all at once), then on one card:

1. prints the card (``torch.cuda.get_device_name`` and nvidia-smi's name
   and power limit);
2. the FIXED path: holds B6, B7 and B3 against their plain PyTorch
   versions at the shapes the path gives them, times the kernel, the
   plain version and one library call computing the same function (CUDA
   events, warm-up, then the median of 10 launches), and drives the path
   once at full size -- 1,000,000 rows x 212 fixed-width columns (an
   INT64 key in [0, 4096), a FLOAT32 value and 210 columns cycling the
   nine integer types of the reference's ``row_conversion_fixed``
   benchmark, validity on every third of them, 792 bytes a row) through
   ``convert_to_rows`` -> ``convert_from_rows`` ->
   ``groupby_sum_bounded(key, value, 4096)`` with every launch counter set
   to 0 just before and read just after, checked against a numpy oracle;
3. the STRING path: the same three calls on 1,000,000 rows x 155 columns
   of the reference's ``row_conversion_mixed_strings`` axis (INT32,
   FLOAT64, INT64, INT16 cycling, every tenth column STRING of 1-32
   bytes; column 1 the FLOAT32 value, column 2 the INT64 key; validity on
   every third column, string columns among them, so null strings occur),
   about 1.3 KB a row. One run records the arguments the path hands B8,
   B9, B10 and B5, and each is held against its plain version and timed
   on exactly those; the counted run then must launch all seven kernels,
   and its rows, columns, offsets and chars are checked byte for byte;
4. the JOIN path, TPC-DS q3's shape (a fact batch against a dimension):
   a store_sales-like batch of 1,048,576 rows x 10 columns (INT32
   surrogate keys, INT32 quantity, FLOAT32 prices and profit, an INT64,
   a DECIMAL128; item_sk uniform in [0, 131,072) with 10% nulls, every
   third column nullable) and an item-like dimension of 65,536 rows
   (unique item_sk, i_brand_id in [0, 4096), i_manufact_id, two STRING
   columns of 1-50 bytes) through ``hash_partition(fact, 200,
   ["item_sk"])`` (B1) -> ``inner_join(.., dim, ["item_sk"])`` (the paged
   table and B4, then the gathers) -> ``groupby_sum_bounded(i_brand_id,
   ss_ext_sales_price, 4096)`` (B3). B1 and B4 are held against their
   plain versions at the path's shapes (B4 also on INT64 copies of the
   keys), the counted run must launch B1, B4 and B3, and the partition
   ids, both gather maps (inner and left), every joined column, the
   counts and the sums are checked against numpy oracles;
5. the ONEHOT path, B2's own entry point
   (``hopper_kernels.groupby_sum_bounded``, the counterpart of the
   reference's ``pallas_groupby_sum_bounded``) at the shape its comment
   measures: 1,000,000 INT64 keys uniform in [-5, 4101) with a few >= 2^32
   (dropped, not wrapped) x 4096 keys, float32 values N(0, 1) x 100. B2
   is held against its plain version and against B3's sums on the same
   inputs (rtol/atol 1e-4, the reference's bound), timed beside one
   ``index_add_`` library call (CUDA events in 30 alternating turns, the
   profiler's device time, the host's enqueue time), the counted run must launch it once, and the
   same run under the profiler must put one kernel, B2's, on the card and
   nothing else;
6. the TPCH path, BASELINE.json configs[1]: the port's ``gen_lineitem`` at
   6,001,215 rows (TPC-H SF1's lineitem cardinality, 7 columns) through
   ``q1`` and ``q6`` on the operator tier, then ``q1_fused`` and
   ``q6_fused`` through the pipeline. Every sum and mean is held bit for
   bit against an exact rational oracle (integer mantissas summed per
   exponent in numpy, combined as Python integers, rounded once by
   ``Fraction``), counts exactly, and the pipeline against the operator
   tier bit for bit; per-stage times (filter, project, aggregate, end to
   end), peak memory and a profile. It also times the exact accumulator's
   two per-segment reductions (masked sums, ``index_add_``) at q1's shape;
7. prints one ``{"kernels": [...]}`` line (ten kernels) and, last, the
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
STR_COLS = 155
NUM_KEYS = 4096
SEED = 20261016
REPS = 10
PLAIN_REPS = 3  # the plain versions at the string path's shapes take seconds
# float32 sums: the reference's own bound for its group-by kernel; the
# kernel's atomics add in an order that changes from run to run
RTOL, ATOL = 2e-6, 1e-3
ORACLE_ROWS = 4096  # rows of the blob held against a numpy row encoder
# the join path: a store_sales-like fact batch against an item-like
# dimension at the paged table's build cap (TPC-DS q3's shape)
FACT_ROWS = 1_048_576
DIM_ROWS = 65_536
ITEM_DOMAIN = 131_072  # item_sk range: about half the valid probes match
PARTITIONS = 200  # Spark's default spark.sql.shuffle.partitions
STRING_PATH_KERNELS = ("expand_u32_planes", "pack_u8_planes", "groupby_sum_outer", "rotl_take",
                       "var_accumulate", "asm_epilogue", "ragged_compact")
JOIN_PATH_KERNELS = ("partition_map", "probe_paged", "groupby_sum_outer")
# the onehot path: B2's entry point at the shape its reference measures
ONEHOT_ROWS = 1_000_000
B2_TOL = 1e-4  # the reference's bound for its one-hot kernel
# the tpch path: TPC-H SF1's lineitem cardinality (TPC-H spec 4.2.5)
LINEITEM_ROWS = 6_001_215


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


def _time_turns(fns, reps: int = 3 * REPS, warm: int = 2):
    """Median CUDA-event time of one call of each of ``fns``, timed in
    turns (one call of each a round), so that drift on the shared host
    falls on all of them alike."""
    import torch

    for fn in fns:
        for _ in range(warm):
            fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for _ in range(reps):
        for fn, ts in zip(fns, times):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end))
    return [float(np.median(ts)) for ts in times]


def _device_activities(fn, reps: int = 1, warm: bool = True):
    """The device activities (kernels, copies, fills) that ``reps`` calls
    of ``fn`` enqueue, as (name, us) from torch.profiler's CUDA activity,
    after one warm call unless ``warm`` is False. The tracer runs a
    warm-up step with one sleep kernel first, so the calls' first launch
    is not lost to its start; that marker is left out of the result."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    if warm:
        fn()
    torch.cuda.synchronize()
    got = []

    def keep(prof):
        got.extend((e.name, e.time_range.elapsed_us()) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.name)

    with profile(activities=[ProfilerActivity.CUDA], on_trace_ready=keep,
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        prof.step()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        prof.step()
    return got


def _host_us(fn, reps: int = 100) -> float:
    """Host microseconds a call of ``fn`` takes to enqueue its work (no
    synchronize inside the timed loop), after a warm call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def _device_ms(fn, kernel: str, reps: int = 20) -> float:
    """Mean device time of the kernels named like ``kernel`` over ``reps``
    calls of ``fn``: the kernel alone, without the wrapper's host work that
    CUDA events around a call also take in. Raises when the profiler
    recorded no such kernel (a wrong name, or a kernel that did not run)."""
    us = [t for name, t in _device_activities(fn, reps) if kernel in name]
    if not us:
        raise AssertionError(f"the profiler recorded no device kernel named like {kernel!r}")
    return float(np.mean(us)) / 1e3


def _fmt_stages(stage) -> str:
    return ", ".join(f"{k} {v:.2f}" for k, v in stage.items())


def _warm_stages(run_main, reps: int = 3):
    """Per-stage medians (host ms, each stage ending in a device
    synchronize) over ``reps`` warm runs of ``_main_path``."""
    stages = [run_main()[-1] for _ in range(reps)]
    return {k: float(np.median([s[k] for s in stages])) for k in stages[0]}


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


def _str_schema(pdt):
    """The reference's row_conversion_mixed_strings axis
    (benchmarks/microbench.py:264-292): 155 columns cycling INT32,
    FLOAT64, INT64, INT16, every tenth STRING; column 1 becomes the FLOAT32
    value and column 2 (already INT64) the key."""
    base = [pdt.INT32, pdt.FLOAT64, pdt.INT64, pdt.INT16]
    dtypes = [pdt.STRING if i % 10 == 0 else base[i % 4] for i in range(STR_COLS)]
    dtypes[1] = pdt.FLOAT32
    return dtypes


def _host_str_table(dtypes, rows: int, seed: int):
    """Seeded storage arrays (STRING as (offsets int32, chars uint8), 1-32
    random bytes a string, null strings empty) and validity masks, every
    third column nullable."""
    from spark_rapids_jni_tpu_torch.columnar.dtype import TypeId

    rng = np.random.default_rng(seed)
    arrays, valids = [], []
    for i, d in enumerate(dtypes):
        v = rng.random(rows) < 0.9 if i % 3 == 0 else None
        if d.id == TypeId.STRING:
            lens = rng.integers(1, 33, rows, dtype=np.int64)
            if v is not None:
                lens[~v] = 0
            offs = np.zeros(rows + 1, np.int32)
            np.cumsum(lens, out=offs[1:])
            a = (offs, rng.integers(0, 256, int(offs[-1]), dtype=np.uint8))
        elif i == 1:
            a = rng.standard_normal(rows, dtype=np.float32)
        elif i == 2:
            a = rng.integers(0, NUM_KEYS, rows, dtype=np.int64)
        elif d.id == TypeId.FLOAT64:
            a = rng.standard_normal(rows)
        else:
            info = np.iinfo(d.np_dtype)
            a = rng.integers(info.min, info.max, rows, dtype=d.np_dtype, endpoint=True)
        arrays.append(a)
        valids.append(v)
    return arrays, valids


def _oracle_str_rows(layout, dtypes, arrays, valids, rows: int):
    """JCUDF rows of the first ``rows`` rows, placed byte by byte in numpy:
    each STRING slot is (offset from the row start, length) as u32, the
    characters follow fixed_end column after column, rows pad to 8 bytes.
    Returns (blob bytes, [rows + 1] row offsets)."""
    from spark_rapids_jni_tpu_torch.columnar.dtype import TypeId

    fe = layout.fixed_end
    fixed = np.zeros((rows, fe), np.uint8)
    var_off = np.full(rows, fe, np.int64)
    pieces = [[] for _ in range(rows)]
    for i, (d, a) in enumerate(zip(dtypes, arrays)):
        s = layout.col_starts[i]
        if d.id == TypeId.STRING:
            offs, chars = a
            lens = np.diff(offs[: rows + 1]).astype(np.int64)
            fixed[:, s : s + 4] = var_off.astype("<u4").view(np.uint8).reshape(rows, 4)
            fixed[:, s + 4 : s + 8] = lens.astype("<u4").view(np.uint8).reshape(rows, 4)
            var_off += lens
            for r in range(rows):
                pieces[r].append(chars[offs[r] : offs[r + 1]].tobytes())
        else:
            by = np.ascontiguousarray(a[:rows]).view(np.uint8).reshape(rows, -1)
            fixed[:, s : s + by.shape[1]] = by
        v = np.ones(rows, bool) if valids[i] is None else valids[i][:rows]
        fixed[:, layout.validity_offset + i // 8] |= v.astype(np.uint8) << (i % 8)
    out, offsets = [], [0]
    for r in range(rows):
        row = fixed[r].tobytes() + b"".join(pieces[r])
        row += b"\0" * ((-len(row)) % 8)
        out.append(row)
        offsets.append(offsets[-1] + len(row))
    return np.frombuffer(b"".join(out), np.uint8), np.array(offsets, np.int64)


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
        device_ms=_device_ms(lambda: hk.groupby_sum_outer(keys, vals, NUM_KEYS),
                             "groupby_shared_kernel"),
        plain_ms=_time_ms(lambda: hk.groupby_sum_outer_plain(keys, vals, NUM_KEYS)),
        library_ms=_time_ms(library),
        # reads 12 B a row (int64 key, f32 value), writes 12 B a key
        # (f32 sum, int64 count); one add a row is far below the f32 rate
        bound_ms=(12 * n + 12 * NUM_KEYS) / rate * 1e3, bound_by="bytes",
        shape=f"int64 [{n}] keys, float32 [{n}] values, K={NUM_KEYS}",
    )
    return results


def _profile_phase(run_path, top: int = 8, watch=()):
    """One warm main-path run under torch.profiler: device busy time by
    kernel and by aten op, and the device's idle share of the host window.
    Kernels whose names contain a ``watch`` string are printed whatever
    their rank, and their device ms land in the result's ``watched``."""
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
    watched = {}
    for w in watch:
        hits = [(name, us, cnt) for name, (us, cnt) in by_kernel.items() if w in name]
        watched[w] = sum(us for _, us, _ in hits) / 1e3
        for name, us, cnt in hits:
            print(f"profile kernel (watched): {us / 1e3:9.4f} ms x{cnt:<4d} {name[:110]}", flush=True)
    return {"device_busy_ms": busy_us / 1e3, "host_window_ms": wall_ms,
            "idle_share": 1 - busy_us / 1e3 / wall_ms, "kernel_launches": len(spans),
            "watched": watched}


def _main_path(table, dtypes, key: int, value: int):
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
    sums, counts = aggregate.groupby_sum_bounded(dec.columns[key].data, dec.columns[value].data,
                                                 NUM_KEYS)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    stage["encode_ms"] = (t1 - t0) * 1e3
    stage["decode_ms"] = (t2 - t1) * 1e3
    stage["groupby_ms"] = (t3 - t2) * 1e3
    stage["end_to_end_ms"] = (t3 - t0) * 1e3
    return rows, dec, sums, counts, stage


def _check_groupby(keys, vals, sums, counts) -> float:
    want_c = np.bincount(keys, minlength=NUM_KEYS)
    want_s = np.bincount(keys, weights=vals.astype(np.float64), minlength=NUM_KEYS)
    got_s, got_c = sums.cpu().numpy(), counts.cpu().numpy()
    if not np.array_equal(got_c, want_c):
        raise AssertionError("group-by counts differ from np.bincount")
    if not np.allclose(got_s, want_s, rtol=RTOL, atol=ATOL):
        raise AssertionError("group-by sums outside rtol 2e-6 / atol 1e-3 of the float64 oracle")
    return float(np.max(np.abs(got_s - want_s)))


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
    return _check_groupby(arrays[0], arrays[1], sums, counts)


def _capture_string_kernels(run):
    """Run ``run`` once with the wrappers of B8, B9, B10 and B5 recording
    the arguments the string path hands them, and restore the wrappers.
    Returns {kernel: [(wrapper, args), ...]}."""
    from spark_rapids_jni_tpu_torch.ops import hopper_kernels as hk
    from spark_rapids_jni_tpu_torch.ops import ragged_bytes as rb
    from spark_rapids_jni_tpu_torch.ops import row_conversion as rc

    seen = {"rotl_take": [], "var_accumulate": [], "asm_epilogue": [], "ragged_compact": []}
    sites = [(rb, "rotl_take", "rotl_take"), (rb, "rotl_take32", "rotl_take"),
             (rc, "var_accumulate", "var_accumulate"), (rb, "asm_epilogue", "asm_epilogue"),
             (hk, "ragged_compact", "ragged_compact")]
    originals = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in sites]

    def recorder(fn, key):
        def call(*args, **kwargs):  # kwargs: only B5's pool32, unused on the card
            seen[key].append((fn, args))
            return fn(*args, **kwargs)
        # a wrapper counts through its module-level name, which is this
        # recorder while it is installed: the capture run's launches land
        # here and leave the real counts alone
        call.launches = 0
        return call

    try:
        for mod, attr, key in sites:
            setattr(mod, attr, recorder(getattr(mod, attr), key))
        run()
    finally:
        for mod, attr, fn in originals:
            setattr(mod, attr, fn)
    return seen


def _string_kernel_phase(seen, rate: float):
    """Each string kernel against its plain version on the arguments the
    string path gave it, and its times summed over the path's launches
    (CUDA events around all of a shape's launches; ``parts`` splits them
    by shape)."""
    import torch
    from spark_rapids_jni_tpu_torch.ops import hopper_kernels as hk
    from spark_rapids_jni_tpu_torch.ops import ragged_bytes as rb

    def u32(x):
        return x if x.dtype == torch.int32 else rb._as_u32(x)

    def u8(x):
        return x if x.dtype == torch.uint8 else rb._as_u8(x)

    def measure(calls, kernel, plain, library, nbytes):
        for args in calls:
            got, want = kernel(*args), plain(*args)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{kernel.__name__} disagrees with its plain version")
        return dict(
            launches=len(calls),
            ms=_time_ms(lambda: [kernel(*a) for a in calls]),
            plain_ms=_time_ms(lambda: [plain(*a) for a in calls], reps=PLAIN_REPS, warm=1),
            library_ms=None if library is None else _time_ms(
                lambda: [library(*a) for a in calls], reps=PLAIN_REPS, warm=1),
            bound_ms=sum(nbytes(*a) for a in calls) / rate * 1e3,
        )

    def combine(parts, **extra):
        out = {k: sum(p[k] for p in parts.values()) for k in ("ms", "plain_ms", "bound_ms")}
        libs = [p["library_ms"] for p in parts.values()]
        out["library_ms"] = None if None in libs else sum(libs)
        return dict(out, max_abs_err=0.0, bound_by="bytes", parts=parts, **extra)

    results = {}

    # B8: 16 string extractions (encode) and one fixed-section gather (decode)
    groups = {}
    for fn, (x, sh, out_w) in seen["rotl_take"]:
        groups.setdefault((tuple(u8(x).shape), out_w), []).append((fn, x, sh, out_w))
    parts = {}
    for (shape, out_w), calls in groups.items():
        fn = calls[0][0]
        parts[f"uint8 [{shape[0]}, {shape[1]}] -> [{shape[0]}, {out_w}]"] = measure(
            [c[1:] for c in calls], fn,
            lambda x, sh, w: rb.rotl_take_plain(u32(x), sh, w),
            lambda x, sh, w: torch.gather(
                u8(x), 1, (torch.arange(w, device=x.device)[None, :] + sh[:, None]) % u8(x).shape[1]),
            # the window's bytes, the shift, the output
            lambda x, sh, w: x.shape[0] * (2 * w + 4),
        )
    results["rotl_take"] = combine(parts, library="torch.gather with its index built in the "
                                                  "timed region")

    # B9: the variable sections, once
    parts = {}
    for fn, (mats, shifts, maxvar) in seen["var_accumulate"]:
        n = mats[0].shape[0]
        parts[f"{len(mats)} x uint8 [{n}, <= {max(m.shape[1] for m in mats)}] -> "
              f"[{n}, {maxvar}]"] = measure(
            [(mats, shifts, maxvar)], fn, rb.var_accumulate_plain, None,
            lambda m, s, w: sum(x.numel() for x in m) + 4 * n * len(m) + n * w)
    results["var_accumulate"] = combine(
        parts, library="none: no one call ORs K byte-shifted matrices into one",
        device_ms=sum(_device_ms(lambda: fn(*args), "var_accumulate_tile_kernel")
                      for fn, args in seen["var_accumulate"]),
        host_us=sum(_host_us(lambda: fn(*args), reps=10) for fn, args in seen["var_accumulate"]))

    # B10: the row-blob tiles, once
    parts = {}
    for fn, args in seen["asm_epilogue"]:
        t, g = args[0].shape[0], args[-1]
        parts[f"3 x int32 [{t}, {g // 4}] -> [{t}, {g // 4}]"] = measure(
            [args], fn, rb.asm_epilogue_plain, None,
            # G source bytes a tile (alen from the window, the rest from the
            # next row's head), three scalars, G bytes out
            lambda *a: a[0].shape[0] * (2 * a[-1] + 12))
    results["asm_epilogue"] = combine(parts, library="none: the zero-filled shift and the select "
                                                    "between two sources need a concatenated "
                                                    "copy before any one gather")

    # B5: one compaction per string column, over the one row blob
    calls = [args for _, args in seen["ragged_compact"]]
    pool = calls[0][0]
    pool32 = rb.build_pool32(pool)  # the plain version's word view, once per blob

    def library(pool, base, offs, total):
        lens = offs[1:] - offs[:-1]
        return pool[torch.repeat_interleave(base - offs[:-1], lens, output_size=total)
                    + torch.arange(total, device=pool.device)]

    parts = {f"{len(calls)} x uint8 blob [{pool.shape[0]}] -> [{calls[0][3]}]": measure(
        calls, seen["ragged_compact"][0][0],
        lambda p, b, o, t: hk.ragged_compact_plain(p, b, o, t, pool32=pool32),
        library,
        lambda p, b, o, t: 2 * t + 8 * b.shape[0] + 8 * o.shape[0])}
    results["ragged_compact"] = combine(parts, library="pool[repeat_interleave(base - offs[:-1], "
                                                      "lens) + arange(total)], index built in "
                                                      "the timed region")
    return results


def _check_string_path(layout, dtypes, arrays, valids, rows, dec, sums, counts):
    from spark_rapids_jni_tpu_torch.columnar.dtype import TypeId

    if len(rows) != 1 or len(rows[0]) != ROWS:
        raise AssertionError("row batch count or length is wrong")
    want_blob, want_offs = _oracle_str_rows(layout, dtypes, arrays, valids, ORACLE_ROWS)
    offs = rows[0].offsets.cpu().numpy()
    if not np.array_equal(offs[: ORACLE_ROWS + 1], want_offs):
        raise AssertionError("row offsets differ from the numpy encoder")
    lens = sum(np.diff(a[0]).astype(np.int64) for d, a in zip(dtypes, arrays) if d.id == TypeId.STRING)
    sizes = (layout.fixed_end + lens + 7) // 8 * 8
    if not np.array_equal(offs, np.concatenate([[0], np.cumsum(sizes)])):
        raise AssertionError("row offsets are not the cumsum of the 8-aligned row sizes")
    blob = rows[0].child.data[: want_blob.shape[0]].cpu().numpy().view(np.uint8)
    if not np.array_equal(blob, want_blob):
        bad = int(np.flatnonzero(blob != want_blob)[0])
        raise AssertionError(f"row blob differs from the numpy encoder at byte {bad}")
    for i, (d, col, a, v) in enumerate(zip(dtypes, dec.columns, arrays, valids)):
        if d.id == TypeId.STRING:
            if not (np.array_equal(col.offsets.cpu().numpy(), a[0])
                    and np.array_equal(col.chars.cpu().numpy(), a[1])):
                raise AssertionError(f"decoded string column {i} differs from the input")
        else:
            got, want = col.to_numpy(), np.ascontiguousarray(a)
            if got.itemsize != want.itemsize or not np.array_equal(got.view(np.uint8),
                                                                   want.view(np.uint8)):
                raise AssertionError(f"decoded column {i} differs from the input bits")
        vm = col.valid_mask().cpu().numpy()
        if not np.array_equal(vm, np.ones(ROWS, bool) if v is None else v):
            raise AssertionError(f"decoded validity of column {i} differs")
    return _check_groupby(arrays[2], arrays[1], sums, counts)


# ---------------------------------------------------------------------------
# the join path: shuffle write -> inner join -> group-by
# ---------------------------------------------------------------------------

FACT_COLS = [  # store_sales-like (name, type); every third column nullable
    ("ss_sold_date_sk", "INT32"), ("item_sk", "INT32"), ("ss_customer_sk", "INT32"),
    ("ss_store_sk", "INT32"), ("ss_quantity", "INT32"), ("ss_ext_sales_price", "FLOAT32"),
    ("ss_sales_price", "FLOAT32"), ("ss_net_profit", "FLOAT32"), ("ss_ticket_number", "INT64"),
    ("ss_ext_discount_amt", "DECIMAL128")]
DIM_COLS = [  # item-like
    ("item_sk", "INT32"), ("i_brand_id", "INT32"), ("i_manufact_id", "INT32"),
    ("i_brand", "STRING"), ("i_category", "STRING")]


def _pdtype(pdt, name):
    return pdt.decimal128(-2) if name == "DECIMAL128" else getattr(pdt, name)


def _np_strings(rng, n, valid):
    """(offsets int32, chars uint8): 1-50 printable bytes a row (TPC-DS
    char(50)), null rows empty."""
    lens = rng.integers(1, 51, n)
    if valid is not None:
        lens[~valid] = 0
    offs = np.zeros(n + 1, np.int32)
    np.cumsum(lens, out=offs[1:])
    return offs, rng.integers(32, 127, int(offs[-1]), dtype=np.uint8)


def _join_inputs(seed: int):
    """Seeded host arrays of the fact batch and the dimension: (arrays,
    validity masks) for each side."""
    rng = np.random.default_rng(seed)
    fa, fv = [], []
    for i, (name, tn) in enumerate(FACT_COLS):
        if name == "item_sk":
            a, v = rng.integers(0, ITEM_DOMAIN, FACT_ROWS).astype(np.int32), rng.random(FACT_ROWS) >= 0.1
        else:
            v = rng.random(FACT_ROWS) < 0.9 if i % 3 == 0 else None
            if tn == "INT32":
                a = rng.integers(0, 1 << 20, FACT_ROWS).astype(np.int32)
            elif tn == "INT64":
                a = rng.integers(0, 1 << 40, FACT_ROWS)
            elif tn == "FLOAT32":
                a = (rng.random(FACT_ROWS) * 200.0).astype(np.float32)
            else:
                a = rng.integers(0, 2**32, (FACT_ROWS, 4), dtype=np.uint32)
        fa.append(a)
        fv.append(v)
    cat_valid = rng.random(DIM_ROWS) < 0.95
    da = [rng.choice(ITEM_DOMAIN, DIM_ROWS, replace=False).astype(np.int32),
          rng.integers(0, NUM_KEYS, DIM_ROWS).astype(np.int32),
          rng.integers(1, 1001, DIM_ROWS).astype(np.int32),
          _np_strings(rng, DIM_ROWS, None), _np_strings(rng, DIM_ROWS, cat_valid)]
    dv = [None, None, None, None, cat_valid]
    return (fa, fv), (da, dv)


def _np_partition(keys: np.ndarray, valid, p: int) -> np.ndarray:
    """pmod(murmur3_32(key, 42), p) of int32 keys in numpy uint32; a null
    row keeps the seed."""
    def rotl(x, r):
        return (x << np.uint32(r)) | (x >> np.uint32(32 - r))

    with np.errstate(over="ignore"):
        k = keys.view(np.uint32) * np.uint32(0xCC9E2D51)
        k = rotl(k, 15) * np.uint32(0x1B873593)
        h = rotl(np.uint32(42) ^ k, 13) * np.uint32(5) + np.uint32(0xE6546B64)
        h = h ^ np.uint32(4)
        h = (h ^ (h >> np.uint32(16))) * np.uint32(0x85EBCA6B)
        h = (h ^ (h >> np.uint32(13))) * np.uint32(0xC2B2AE35)
        h = h ^ (h >> np.uint32(16))
    h = np.where(valid, h, np.uint32(42))
    return np.mod(h.view(np.int32).astype(np.int64), p)


def _np_join_maps(lk, lvalid, rk, rvalid, how: str):
    """Sort-probe gather maps in numpy: left rows ascending, and within a
    left row its matching build rows ascending; -1 for a left join's
    unmatched rows."""
    ridx = np.flatnonzero(rvalid) if rvalid is not None else np.arange(rk.shape[0])
    ridx = ridx[np.argsort(rk[ridx], kind="stable")]
    rs = rk[ridx]
    lo = np.searchsorted(rs, lk, side="left")
    hi = np.searchsorted(rs, lk, side="right")
    cnt = np.where(lvalid, hi - lo, 0)
    out_cnt = cnt if how == "inner" else np.maximum(cnt, 1)
    lmap = np.repeat(np.arange(lk.shape[0]), out_cnt)
    within = np.arange(lmap.shape[0]) - np.repeat(np.cumsum(out_cnt) - out_cnt, out_cnt)
    rmap = np.where(cnt[lmap] > 0, ridx[np.minimum(lo[lmap] + within, max(rs.shape[0] - 1, 0))], -1)
    return lmap, rmap


def _np_gather(arr, valid, idx):
    """numpy gather with the NULLIFY bounds policy: (data, validity)."""
    oob = idx < 0
    safe = np.where(oob, 0, idx)
    v = ~oob if valid is None else valid[safe] & ~oob
    if isinstance(arr, tuple):
        offs, chars = arr
        lens = (offs[1:] - offs[:-1]).astype(np.int64)[safe]
        new = np.zeros(idx.shape[0] + 1, np.int64)
        np.cumsum(lens, out=new[1:])
        src = np.repeat(offs[:-1][safe].astype(np.int64) - new[:-1], lens) + np.arange(new[-1])
        return (new.astype(np.int32), chars[src]), v
    return arr[safe], v


def _check_join_table(table, side_arrays, lmap, rmap):
    """Every column of a joined table bit-identical to a numpy gather of
    its input (left columns by ``lmap``, right non-key columns by ``rmap``
    with -1 null), STRING offsets and chars included."""
    (fa, fv), (da, dv) = side_arrays
    want = [_np_gather(a, v, lmap) for a, v in zip(fa, fv)]
    want += [_np_gather(a, v, rmap) for (name, _), a, v in zip(DIM_COLS, da, dv)
             if name != "item_sk"]
    names = [n for n, _ in FACT_COLS] + [n for n, _ in DIM_COLS if n != "item_sk"]
    if table.names != names or table.num_rows != lmap.shape[0]:
        raise AssertionError(f"joined table shape differs: {table.names} x {table.num_rows}")
    for name, col, (data, valid) in zip(names, table.columns, want):
        if isinstance(data, tuple):
            if not (np.array_equal(col.offsets.cpu().numpy(), data[0])
                    and np.array_equal(col.chars.cpu().numpy(), data[1])):
                raise AssertionError(f"joined string column {name} differs from the numpy gather")
        else:
            got = col.to_numpy()
            if not np.array_equal(got.view(np.uint8), np.ascontiguousarray(data).view(np.uint8)):
                raise AssertionError(f"joined column {name} differs from the numpy gather")
        if not np.array_equal(col.valid_mask().cpu().numpy(), valid):
            raise AssertionError(f"joined validity of {name} differs from the numpy gather")


def _join_path(fact, dim):
    """hash_partition -> inner_join -> groupby_sum_bounded, once."""
    import torch
    from spark_rapids_jni_tpu_torch.ops import aggregate, join
    from spark_rapids_jni_tpu_torch.parallel import shuffle

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    part, offsets = shuffle.hash_partition(fact, PARTITIONS, ["item_sk"])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    joined = join.inner_join(part, dim, ["item_sk"])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    sums, counts = aggregate.groupby_sum_bounded(joined.column("i_brand_id").data,
                                                 joined.column("ss_ext_sales_price").data, NUM_KEYS)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    stage = {"shuffle_ms": (t1 - t0) * 1e3, "join_ms": (t2 - t1) * 1e3,
             "groupby_ms": (t3 - t2) * 1e3, "end_to_end_ms": (t3 - t0) * 1e3}
    return part, offsets, joined, sums, counts, stage


def _join_kernel_phase(fact, part, dim, rate: float):
    """B1 and B4 against their plain versions at the join path's shapes:
    B1 on the fact batch's key column, B4 on the partitioned key column
    against the dimension's table; B4 once more on INT64 copies of both
    (the 64-bit route)."""
    import torch
    from spark_rapids_jni_tpu_torch.ops import hopper_kernels as hk
    from spark_rapids_jni_tpu_torch.ops import paged_join as pj

    results = {}
    key = fact.column("item_sk")
    n = key.data.shape[0]
    got = hk.partition_map(key.data, PARTITIONS, key.validity)
    want = hk.partition_map_plain(key.data, PARTITIONS, key.validity)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("partition_map disagrees with its plain version")
    results["partition_map"] = dict(
        max_abs_err=0.0,
        ms=_time_ms(lambda: hk.partition_map(key.data, PARTITIONS, key.validity)),
        device_ms=_device_ms(lambda: hk.partition_map(key.data, PARTITIONS, key.validity),
                             "partition_map_kernel"),
        plain_ms=_time_ms(lambda: hk.partition_map_plain(key.data, PARTITIONS, key.validity)),
        library_ms=None, library="none: no one PyTorch call computes murmur3",
        # 4 B key + 1 B validity in, 4 B id out a row
        bound_ms=9 * n / rate * 1e3, bound_by="bytes",
        shape=f"int32 [{n}] keys + validity, P={PARTITIONS}",
    )

    pkey, dkey = part.column("item_sk"), dim.column("item_sk")
    tab = pj.build_paged_table(dkey.data, dkey.validity)
    if tab is None:
        raise AssertionError("the dimension's key column did not fit the paged table")
    print(f"paged table: {tab.num_buckets} buckets, n_pages {tab.n_pages}, c_max {tab.c_max}, "
          f"nm {tab.nm}", flush=True)
    lo, eq = hk.probe_paged(pkey.data, pkey.validity, tab)
    wlo, weq = hk.probe_paged_plain(pkey.data, pkey.validity, tab)
    torch.cuda.synchronize()
    if not (torch.equal(lo, wlo) and torch.equal(eq, weq)):
        raise AssertionError("probe_paged disagrees with its plain version")
    # the 64-bit route on INT64 copies of the same keys
    tab64 = pj.build_paged_table(dkey.data.to(torch.int64), dkey.validity)
    k64 = pkey.data.to(torch.int64)
    lo64, eq64 = hk.probe_paged(k64, pkey.validity, tab64)
    wlo64, weq64 = hk.probe_paged_plain(k64, pkey.validity, tab64)
    torch.cuda.synchronize()
    if not (torch.equal(lo64, wlo64) and torch.equal(eq64, weq64)):
        raise AssertionError("probe_paged (INT64 keys) disagrees with its plain version")
    if not torch.equal(eq64, eq):
        raise AssertionError("probe_paged match counts differ between INT32 and INT64 keys")
    print(f"probe_paged held against its plain version on INT32 and INT64 keys "
          f"({int(eq.sum())} matches)", flush=True)

    # library yardstick: two searchsorted over the composite (bucket << 32
    # | order word) of the build side, sorted, for the valid probe rows
    bu = pj.order_words(dkey.data)
    comp = torch.sort((pj.bucket_of(bu, tab.num_buckets) << 32) | pj.compare_form(bu)).values
    pu = pj.order_words(pkey.data)
    pcomp = (pj.bucket_of(pu, tab.num_buckets) << 32) | pj.compare_form(pu)
    table_bytes = tab.slots.numel() * 4 + tab.counts.numel() * 4 + tab.meta.numel() * 8
    results["probe_paged"] = dict(
        max_abs_err=0.0,
        ms=_time_ms(lambda: hk.probe_paged(pkey.data, pkey.validity, tab)),
        device_ms=_device_ms(lambda: hk.probe_paged(pkey.data, pkey.validity, tab),
                             "probe_paged_kernel"),
        plain_ms=_time_ms(lambda: hk.probe_paged_plain(pkey.data, pkey.validity, tab)),
        library_ms=_time_ms(lambda: (torch.searchsorted(comp, pcomp, side="left"),
                                     torch.searchsorted(comp, pcomp, side="right"))),
        library="two torch.searchsorted over the sorted int64 (bucket << 32 | order word) "
                "of the build side, composites built outside the timed region",
        # 4 B key + 1 B validity in, 8 B (lo, eq) out a row; the table once
        bound_ms=(13 * n + table_bytes) / rate * 1e3, bound_by="bytes",
        shape=f"int32 [{n}] keys + validity vs {tab.nm} build rows, {tab.n_pages} pages",
        table={"num_buckets": tab.num_buckets, "n_pages": tab.n_pages, "c_max": tab.c_max,
               "nm": tab.nm},
    )
    return results


def _check_join_path(side_arrays, fact, part, offsets, dim, joined, sums, counts):
    """Partition ids, both gather maps, every joined column, counts and
    sums against numpy oracles; the left join too."""
    from spark_rapids_jni_tpu_torch.ops import hashing, join

    (fa, fv), (da, dv) = side_arrays
    key, kv = fa[1], fv[1]
    pid = _np_partition(key, kv, PARTITIONS)
    got = hashing.hash_partition_map([fact.column("item_sk")], PARTITIONS).cpu().numpy()
    if not np.array_equal(got, pid):
        raise AssertionError("partition ids differ from the numpy murmur3")
    order = np.argsort(pid, kind="stable")
    cnt = np.bincount(pid, minlength=PARTITIONS)
    if offsets != (np.cumsum(cnt) - cnt).tolist():
        raise AssertionError("partition offsets differ from the numpy oracle")
    lk, lv = key[order], kv[order]
    pside = ([a[order] if not isinstance(a, tuple) else a for a in fa],
             [None if v is None else v[order] for v in fv])
    maps = {}
    for how in ("inner", "left"):
        want_l, want_r = _np_join_maps(lk, lv, da[0], None, how)
        gl, gr = join.join_gather_maps(part.select(["item_sk"]), dim.select(["item_sk"]), how)
        if not (np.array_equal(gl.cpu().numpy(), want_l) and np.array_equal(gr.cpu().numpy(), want_r)):
            raise AssertionError(f"{how} join gather maps differ from the numpy sort-probe")
        maps[how] = (want_l, want_r)
    _check_join_table(joined, (pside, (da, dv)), *maps["inner"])
    left = join.left_join(part, dim, ["item_sk"])
    _check_join_table(left, (pside, (da, dv)), *maps["left"])
    lmap, rmap = maps["inner"]
    brand = da[1][rmap]
    price = pside[0][5][lmap]
    want_c = np.bincount(brand, minlength=NUM_KEYS)
    want_s = np.bincount(brand, weights=price.astype(np.float64), minlength=NUM_KEYS)
    if not np.array_equal(counts.cpu().numpy(), want_c):
        raise AssertionError("join path group-by counts differ from np.bincount")
    got_s = sums.cpu().numpy()
    if not np.allclose(got_s, want_s, rtol=RTOL, atol=ATOL):
        raise AssertionError("join path sums outside rtol 2e-6 / atol 1e-3 of the float64 oracle")
    return {"inner_rows": int(lmap.shape[0]), "left_rows": int(maps["left"][0].shape[0]),
            "null_keys": int((~kv).sum()), "sum_max_abs_err": float(np.max(np.abs(got_s - want_s)))}


# ---------------------------------------------------------------------------
# the onehot path: B2's entry point
# ---------------------------------------------------------------------------


def _onehot_inputs(seed: int):
    """INT64 keys uniform in [-5, 4101) with every 100,003rd >= 2^32, and
    float32 values N(0, 1) x 100."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(-5, NUM_KEYS + 5, ONEHOT_ROWS)
    keys[::100_003] = 2**32 + rng.integers(0, NUM_KEYS, keys[::100_003].shape[0])
    vals = (rng.standard_normal(ONEHOT_ROWS) * 100).astype(np.float32)
    return keys, vals


def _onehot_kernel_phase(keys, vals, rate: float):
    """B2 against its plain version and against B3's sums, with its times."""
    import torch
    from spark_rapids_jni_tpu_torch.ops import hopper_kernels as hk

    got = hk.groupby_sum_bounded(keys, vals, NUM_KEYS)
    want = hk.groupby_sum_bounded_plain(keys, vals, NUM_KEYS)
    b3, _ = hk.groupby_sum_outer(keys, vals, NUM_KEYS)
    torch.cuda.synchronize()
    if not torch.allclose(got, want, rtol=B2_TOL, atol=B2_TOL):
        raise AssertionError("groupby_sum_bounded disagrees with its plain version")
    if not torch.allclose(got, b3, rtol=B2_TOL, atol=B2_TOL):
        raise AssertionError("groupby_sum_bounded disagrees with B3's sums")
    seg = torch.where((keys >= 0) & (keys < NUM_KEYS), keys, NUM_KEYS)  # outside the timed call
    n = keys.shape[0]

    def library():
        return torch.zeros(NUM_KEYS + 1, dtype=torch.float32,
                           device=keys.device).index_add_(0, seg, vals)[:NUM_KEYS]

    # both a few microseconds of device work behind ~20 us of host work:
    # timed in turns, 30 rounds
    ms, library_ms = _time_turns([lambda: hk.groupby_sum_bounded(keys, vals, NUM_KEYS), library])
    return {"groupby_sum_bounded": dict(
        max_abs_err=float((got - want).abs().max()),
        max_abs_err_vs_b3=float((got - b3).abs().max()),
        ms=ms,
        device_ms=_device_ms(lambda: hk.groupby_sum_bounded(keys, vals, NUM_KEYS),
                             "groupby_bounded_kernel"),
        host_us=_host_us(lambda: hk.groupby_sum_bounded(keys, vals, NUM_KEYS)),
        library_host_us=_host_us(library),
        plain_ms=_time_ms(lambda: hk.groupby_sum_bounded_plain(keys, vals, NUM_KEYS)),
        library_ms=library_ms,
        library="torch.zeros(K + 1).index_add_(0, seg, vals)[:K], seg built outside the timed region",
        # reads 12 B a row (int64 key, f32 value), writes 4 B a key
        bound_ms=(12 * n + 4 * NUM_KEYS) / rate * 1e3, bound_by="bytes",
        shape=f"int64 [{n}] keys, float32 [{n}] values, K={NUM_KEYS}",
    )}


def _check_onehot(keys, vals, sums) -> float:
    ind = (keys >= 0) & (keys < NUM_KEYS)
    want = np.bincount(keys[ind], weights=vals[ind].astype(np.float64), minlength=NUM_KEYS)
    got = sums.cpu().numpy()
    if not np.allclose(got, want, rtol=B2_TOL, atol=B2_TOL):
        raise AssertionError("onehot sums outside rtol/atol 1e-4 of the float64 oracle")
    return float(np.max(np.abs(got - want)))


# ---------------------------------------------------------------------------
# the tpch path: q1 and q6 on the operator tier and through the pipeline
# ---------------------------------------------------------------------------

Q1_SUMS = [("qty_sum", "l_quantity"), ("price_sum", "l_extendedprice"),
           ("disc_price_sum", "disc_price"), ("charge_sum", "charge")]
Q1_MEANS = [("qty_mean", "l_quantity"), ("price_mean", "l_extendedprice"),
            ("disc_mean", "l_discount")]


def _exact_sums(x: np.ndarray, group: np.ndarray, num: int):
    """Exact per-group sums of float64 values as Python integers over a
    common power of two: each value is an integer mantissa times 2^e; the
    mantissas, split into 27-bit halves so every float64 partial sum stays
    an exact integer below 2^53, are summed per (group, e) in numpy and
    combined in Python integers. Returns ([num] numerators, exponent)."""
    m, e = np.frexp(x)
    mi = (m * 2.0**53).astype(np.int64)
    e = e.astype(np.int64) - 53
    e0 = int(e.min()) if e.size else 0
    es = np.unique(e)
    key = group * es.shape[0] + np.searchsorted(es, e)
    hi = np.bincount(key, weights=(mi >> 27).astype(np.float64), minlength=num * es.shape[0])
    lo = np.bincount(key, weights=(mi & ((1 << 27) - 1)).astype(np.float64),
                     minlength=num * es.shape[0])
    out = [0] * num
    for g in range(num):
        for j, ej in enumerate(es):
            k = g * es.shape[0] + j
            out[g] += ((int(hi[k]) << 27) + int(lo[k])) << int(ej - e0)
    return out, e0


def _frac_float(num_: int, e0: int, den: int = 1) -> float:
    from fractions import Fraction

    return float(Fraction(num_ * 2**max(e0, 0), den * 2**max(-e0, 0)))


def _tpch_oracle(li):
    """q1 (dense over the 3 x 2 domain) and q6 from the host copy of
    lineitem, every float exact: the row products are float64 products
    (one rounding per operator, as the expression tier computes them), and
    the sums and means the nearest float64 of the exact rationals."""
    h = {n: c.to_numpy() for n, c in zip(li.names, li.columns)}
    f = {n: h[n].view(np.float64) for n in ("l_quantity", "l_extendedprice", "l_discount", "l_tax")}
    ship = h["l_shipdate"]
    keep = ship <= 2526 - 90
    grp = (h["l_returnflag"].astype(np.int64) * 2 + h["l_linestatus"])[keep]
    cols = {k: v[keep] for k, v in f.items()}
    cols["disc_price"] = cols["l_extendedprice"] * (1.0 - cols["l_discount"])
    cols["charge"] = cols["l_extendedprice"] * (1.0 - cols["l_discount"]) * (1.0 + cols["l_tax"])
    count = np.bincount(grp, minlength=6)
    q1 = {"count": count}
    for name, src in Q1_SUMS:
        nums, e0 = _exact_sums(cols[src], grp, 6)
        q1[name] = np.array([_frac_float(v, e0) for v in nums])
    for name, src in Q1_MEANS:
        nums, e0 = _exact_sums(cols[src], grp, 6)
        q1[name] = np.array([_frac_float(v, e0, int(c)) if c else 0.0 for v, c in zip(nums, count)])
    m6 = ((ship >= 731) & (ship < 1096) & (f["l_discount"] >= 0.05) & (f["l_discount"] <= 0.07)
          & (f["l_quantity"] < 24.0))
    rev = f["l_extendedprice"][m6] * f["l_discount"][m6]
    nums, e0 = _exact_sums(rev, np.zeros(rev.shape[0], np.int64), 1)
    return q1, _frac_float(nums[0], e0), int(keep.sum()), int(m6.sum())


def _q1_dense(out):
    """Operator-tier q1 rows as the pipeline's dense [6] arrays."""
    slot = out.column("l_returnflag").to_numpy() * 2 + out.column("l_linestatus").to_numpy()
    res = {}
    for name in [n for n, _ in Q1_SUMS + Q1_MEANS]:
        dense = np.zeros(6, np.float64)
        dense[slot] = out.column(name).to_numpy().view(np.float64)
        res[name] = dense
    res["count"] = np.zeros(6, np.int64)
    res["count"][slot] = out.column("qty_count_all").to_numpy()
    return res


def _q1_stages(li):
    """tpch.q1's steps (the same calls, in order) with a synchronize after
    each: filter (predicate + apply_boolean_mask), project (the two
    expressions), aggregate (groupby_aggregate)."""
    import torch
    from spark_rapids_jni_tpu_torch.columnar import Table
    from spark_rapids_jni_tpu_torch.models import tpch
    from spark_rapids_jni_tpu_torch.ops import copying
    from spark_rapids_jni_tpu_torch.ops.aggregate import groupby_aggregate
    from spark_rapids_jni_tpu_torch.ops.expressions import col, lit

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred = (col("l_shipdate") <= lit(np.int32(tpch.D_1998_12_01 - 90))).evaluate(li)
    t = copying.apply_boolean_mask(li, pred)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    disc_price = (col("l_extendedprice") * (lit(1.0) - col("l_discount"))).evaluate(t)
    charge = (col("l_extendedprice") * (lit(1.0) - col("l_discount"))
              * (lit(1.0) + col("l_tax"))).evaluate(t)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    values = Table([t.column("l_quantity"), t.column("l_extendedprice"), disc_price, charge,
                    t.column("l_discount")], ["qty", "price", "disc_price", "charge", "disc"])
    out = groupby_aggregate(t.select(["l_returnflag", "l_linestatus"]), values,
                            [("qty", "sum"), ("price", "sum"), ("disc_price", "sum"),
                             ("charge", "sum"), ("qty", "mean"), ("price", "mean"),
                             ("disc", "mean"), ("qty", "count_all")])
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    return out, {"filter_ms": (t1 - t0) * 1e3, "project_ms": (t2 - t1) * 1e3,
                 "aggregate_ms": (t3 - t2) * 1e3, "end_to_end_ms": (t3 - t0) * 1e3}


def _q6_stages(li):
    """tpch.q6's steps with a synchronize after each: filter, project,
    aggregate (the constant-key groupby_aggregate and the host read)."""
    import torch
    from spark_rapids_jni_tpu_torch.columnar import Column, Table
    from spark_rapids_jni_tpu_torch.columnar import dtype as pdt
    from spark_rapids_jni_tpu_torch.models import tpch
    from spark_rapids_jni_tpu_torch.ops import copying
    from spark_rapids_jni_tpu_torch.ops.aggregate import groupby_aggregate
    from spark_rapids_jni_tpu_torch.ops.expressions import col, lit

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred = ((col("l_shipdate") >= lit(np.int32(tpch._D_1994_01_01)))
            & (col("l_shipdate") < lit(np.int32(tpch._D_1995_01_01)))
            & (col("l_discount") >= lit(0.05)) & (col("l_discount") <= lit(0.07))
            & (col("l_quantity") < lit(24.0))).evaluate(li)
    t = copying.apply_boolean_mask(li, pred)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    revenue = (col("l_extendedprice") * col("l_discount")).evaluate(t)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    key = Table([Column(pdt.INT8, data=torch.zeros((t.num_rows,), dtype=torch.int8,
                                                   device=revenue.device))], ["g"])
    out = groupby_aggregate(key, Table([revenue], ["revenue"]), [("revenue", "sum")])
    value = float(out.column("revenue_sum").data[:1].cpu().numpy().view(np.float64)[0])
    t3 = time.perf_counter()
    return value, {"filter_ms": (t1 - t0) * 1e3, "project_ms": (t2 - t1) * 1e3,
                   "aggregate_ms": (t3 - t2) * 1e3, "end_to_end_ms": (t3 - t0) * 1e3}


def _tpch_path(li):
    """q1 and q6 on the operator tier, then q1_fused and q6_fused, once;
    host ms of each, each ending in a synchronize."""
    import torch
    from spark_rapids_jni_tpu_torch.models import compiled, tpch

    out, stage = {}, {}
    for name, fn in (("q1", tpch.q1), ("q6", tpch.q6), ("q1_fused", compiled.q1_fused),
                     ("q6_fused", compiled.q6_fused)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = fn(li)
        torch.cuda.synchronize()
        stage[f"{name}_ms"] = (time.perf_counter() - t0) * 1e3
    stage["end_to_end_ms"] = sum(stage.values())
    return out, stage


def _check_tpch(li, out):
    """Every sum and mean bit-identical to the exact oracle, counts exact,
    and the pipeline bit-identical to the operator tier."""
    q1_want, q6_want, n_q1, n_q6 = _tpch_oracle(li)
    op = _q1_dense(out["q1"])
    if out["q1"].num_rows != int((q1_want["count"] > 0).sum()):
        raise AssertionError("q1 group count differs from the oracle")
    for name, want in q1_want.items():
        if not np.array_equal(op[name].view(np.uint8), want.view(np.uint8)):
            raise AssertionError(f"q1 {name} differs from the exact oracle: {op[name]} vs {want}")
        fused = out["q1_fused"][name]
        if not np.array_equal(fused.view(np.uint8), op[name].view(np.uint8)):
            raise AssertionError(f"q1_fused {name} differs from the operator tier")
    if not (out["q6"] == q6_want == out["q6_fused"]):
        raise AssertionError(f"q6 differs: op {out['q6']!r}, fused {out['q6_fused']!r}, "
                             f"oracle {q6_want!r}")
    return {"q1_rows_kept": n_q1, "q6_rows_kept": n_q6, "q6_revenue": q6_want,
            "q1_counts": q1_want["count"].tolist()}


def _f64acc_reductions(li, rounds: int = 6):
    """The exact accumulator at q1's shape (6 groups) over all of
    lineitem's l_extendedprice, with its per-segment reductions as masked
    sums and as one index_add_, timed in turns (masked, index_add_, ...;
    CUDA events, median of 3 a turn) after checking that they agree."""
    import torch
    from spark_rapids_jni_tpu_torch.ops import f64acc

    bits = li.column("l_extendedprice").data
    seg = (li.column("l_returnflag").data.to(torch.int64) * 2 + li.column("l_linestatus").data)
    keep = f64acc.SMALL_SEGMENTS

    def run(small: int):
        f64acc.SMALL_SEGMENTS = small
        try:
            return f64acc.segment_sum_f64bits(bits, seg, 6)
        finally:
            f64acc.SMALL_SEGMENTS = keep

    if not torch.equal(run(16), run(0)):
        raise AssertionError("the two per-segment reductions of f64acc disagree")
    masked, index_add = [], []
    for _ in range(rounds):
        masked.append(_time_ms(lambda: run(16), reps=3))
        index_add.append(_time_ms(lambda: run(0), reps=3))
    return {"rows": int(bits.shape[0]), "segments": 6, "masked_ms": float(np.median(masked)),
            "index_add_ms": float(np.median(index_add)), "masked_turns_ms": masked,
            "index_add_turns_ms": index_add,
            "index_add_faster_turns": int(sum(b < a for a, b in zip(masked, index_add)))}


def _run_counted(wrappers, run):
    """Every launch counter to 0, ``run`` once, the counts back."""
    for w in wrappers.values():
        w.launches = 0
    out = run()
    return out, {k: w.launches for k, w in wrappers.items()}


def _print_kernels(kernels):
    for k, r in kernels.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        dev = "" if r.get("device_ms") is None else f", device {r['device_ms']:.4f} ms"
        dev += "" if r.get("host_us") is None else f", host {r['host_us']:.1f} us a call"
        print(f"kernel {k} [{r.get('shape', '; '.join(r.get('parts', {})))}]: {r['ms']:.4f} ms{dev} "
              f"(plain {r['plain_ms']:.4f}, library {lib}, bound {r['bound_ms']:.4f} by "
              f"{r['bound_by']}), max abs err {r['max_abs_err']}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs only on a card",
              file=sys.stderr)
        return 2
    try:
        from spark_rapids_jni_tpu_torch.columnar import Table
        from spark_rapids_jni_tpu_torch.columnar import dtype as pdt
        from spark_rapids_jni_tpu_torch.interop import carry_table
        from spark_rapids_jni_tpu_torch.models import tpch
        from spark_rapids_jni_tpu_torch.ops import aggregate
        from spark_rapids_jni_tpu_torch.ops import hopper_kernels as hk
        from spark_rapids_jni_tpu_torch.ops import ragged_bytes as rb
        from spark_rapids_jni_tpu_torch.ops import row_conversion as rc
        from spark_rapids_jni_tpu_torch.parallel import shuffle
    except ImportError as e:
        print(f"chip_smoke: the port package is not importable here: {e}", file=sys.stderr)
        return 2

    name, smi_line = _device_phase()
    _build_phase()
    rate = _mem_rate(name)
    wrappers = {"expand_u32_planes": rb.expand_u32_planes, "pack_u8_planes": rb.pack_u8_planes,
                "groupby_sum_outer": hk.groupby_sum_outer, "rotl_take": rb.rotl_take,
                "var_accumulate": rb.var_accumulate, "asm_epilogue": rb.asm_epilogue,
                "ragged_compact": hk.ragged_compact, "partition_map": hk.partition_map,
                "probe_paged": hk.probe_paged, "groupby_sum_bounded": hk.groupby_sum_bounded}
    paths = {}

    # -- the fixed path ------------------------------------------------------
    dtypes = _schema(pdt)
    layout = rc.compute_row_layout(dtypes)
    t0 = time.perf_counter()
    arrays, valids = _host_table(dtypes, ROWS, SEED)
    table = Table.from_numpy(arrays, dtypes, valids, device="cuda")
    torch.cuda.synchronize()
    print(f"fixed input: {ROWS} rows x {len(dtypes)} columns, {layout.row_size_fixed} B a row, "
          f"made and uploaded in {time.perf_counter() - t0:.1f} s", flush=True)

    kernels = _kernel_phase(table, layout, rate)
    _print_kernels(kernels)
    (rows, dec, sums, counts, stage), launches = _run_counted(
        wrappers, lambda: _main_path(table, dtypes, key=0, value=1))
    print(f"fixed path launches: {launches}", flush=True)
    for k in ("expand_u32_planes", "pack_u8_planes", "groupby_sum_outer"):
        if launches[k] < 1:
            raise AssertionError(f"the fixed path never launched {k}")
    sum_err = _check_main_path(layout, arrays, valids, rows, dec, sums, counts)
    print(f"fixed path checked against the numpy oracle: rows bit-identical on the first "
          f"{ORACLE_ROWS} rows, {len(dtypes)} decoded columns bit-identical, counts exact, "
          f"sums max abs err {sum_err:.3g} vs float64", flush=True)
    del rows, dec

    def run_fixed():
        r = rc.convert_to_rows(table)
        d = rc.convert_from_rows(r[0], dtypes)
        aggregate.groupby_sum_bounded(d.columns[0].data, d.columns[1].data, NUM_KEYS)

    torch.cuda.reset_peak_memory_stats()
    warm = _warm_stages(lambda: _main_path(table, dtypes, key=0, value=1))
    peak = torch.cuda.max_memory_allocated() / 2**30
    print("fixed path (host clock, ms): first run " + _fmt_stages(stage) + "; warm median of 3 "
          + _fmt_stages(warm) + f"; peak device memory {peak:.2f} GiB", flush=True)
    profile = _profile_phase(run_fixed)
    paths["fixed"] = {**stage, "warm": warm, "warm_end_to_end_ms": warm["end_to_end_ms"], "rows": ROWS,
                      "columns": len(dtypes), "row_bytes": layout.row_size_fixed,
                      "peak_gib": peak, "launches": launches, "profile": profile}
    del table, arrays, valids
    torch.cuda.empty_cache()

    # -- the string path -----------------------------------------------------
    sdtypes = _str_schema(pdt)
    slayout = rc.compute_row_layout(sdtypes)
    t0 = time.perf_counter()
    sarrays, svalids = _host_str_table(sdtypes, ROWS, SEED + 1)
    stable = carry_table(sarrays, sdtypes, svalids, device="cuda")
    torch.cuda.synchronize()
    print(f"string input: {ROWS} rows x {len(sdtypes)} columns ({len(slayout.variable_cols)} "
          f"STRING), fixed_end {slayout.fixed_end}, made and uploaded in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    def run_strings():
        r = rc.convert_to_rows(stable)
        d = rc.convert_from_rows(r[0], sdtypes)
        return aggregate.groupby_sum_bounded(d.columns[2].data, d.columns[1].data, NUM_KEYS)

    seen = _capture_string_kernels(run_strings)
    print("string path hands the kernels: " + ", ".join(
        f"{k} x{len(v)}" for k, v in seen.items()), flush=True)
    skernels = _string_kernel_phase(seen, rate)
    del seen
    torch.cuda.empty_cache()
    _print_kernels(skernels)

    (rows, dec, sums, counts, sstage), slaunches = _run_counted(
        wrappers, lambda: _main_path(stable, sdtypes, key=2, value=1))
    print(f"string path launches: {slaunches}", flush=True)
    for k in STRING_PATH_KERNELS:
        if slaunches[k] < 1:
            raise AssertionError(f"the string path never launched {k}")
    sum_err = _check_string_path(slayout, sdtypes, sarrays, svalids, rows, dec, sums, counts)
    total = int(rows[0].offsets[-1])
    print(f"string path checked against the numpy oracle: rows and offsets bit-identical on the "
          f"first {ORACLE_ROWS} rows, all {ROWS + 1} row offsets exact, {len(sdtypes)} decoded "
          f"columns (string offsets and chars) bit-identical, counts exact, sums max abs err "
          f"{sum_err:.3g} vs float64; blob {total} B", flush=True)
    del rows, dec
    torch.cuda.reset_peak_memory_stats()
    swarm = _warm_stages(lambda: _main_path(stable, sdtypes, key=2, value=1))
    speak = torch.cuda.max_memory_allocated() / 2**30
    print("string path (host clock, ms): first run " + _fmt_stages(sstage) + "; warm median of 3 "
          + _fmt_stages(swarm) + f"; peak device memory {speak:.2f} GiB", flush=True)
    sprofile = _profile_phase(run_strings, top=14)
    paths["strings"] = {**sstage, "warm": swarm, "warm_end_to_end_ms": swarm["end_to_end_ms"],
                        "rows": ROWS,
                        "columns": len(sdtypes), "fixed_end": slayout.fixed_end,
                        "blob_bytes": total, "peak_gib": speak, "launches": slaunches,
                        "profile": sprofile}

    del stable, sarrays, svalids
    torch.cuda.empty_cache()

    # -- the join path -------------------------------------------------------
    t0 = time.perf_counter()
    side_arrays = _join_inputs(SEED + 2)
    (fa, fv), (da, dv) = side_arrays
    fact = Table(carry_table(fa, [_pdtype(pdt, t) for _, t in FACT_COLS], fv, device="cuda").columns,
                 [n for n, _ in FACT_COLS])
    dim = Table(carry_table(da, [_pdtype(pdt, t) for _, t in DIM_COLS], dv, device="cuda").columns,
                [n for n, _ in DIM_COLS])
    torch.cuda.synchronize()
    print(f"join input: fact {FACT_ROWS} rows x {len(FACT_COLS)} columns (item_sk in "
          f"[0, {ITEM_DOMAIN}), {int((~fv[1]).sum())} null), dimension {DIM_ROWS} rows x "
          f"{len(DIM_COLS)} columns ({int(da[3][0][-1]) + int(da[4][0][-1])} string bytes), made "
          f"and uploaded in {time.perf_counter() - t0:.1f} s", flush=True)
    part, _ = shuffle.hash_partition(fact, PARTITIONS, ["item_sk"])
    jkernels = _join_kernel_phase(fact, part, dim, rate)
    del part
    _print_kernels(jkernels)

    (part, offsets, joined, sums, counts, jstage), jlaunches = _run_counted(
        wrappers, lambda: _join_path(fact, dim))
    print(f"join path launches: {jlaunches}", flush=True)
    for k in JOIN_PATH_KERNELS:
        if jlaunches[k] < 1:
            raise AssertionError(f"the join path never launched {k}")
    jcheck = _check_join_path(side_arrays, fact, part, offsets, dim, joined, sums, counts)
    print(f"join path checked against the numpy oracles: partition ids and offsets exact, inner "
          f"and left gather maps exact ({jcheck['inner_rows']} / {jcheck['left_rows']} rows), "
          f"every joined column (string offsets and chars included) bit-identical, counts exact, "
          f"sums max abs err {jcheck['sum_max_abs_err']:.3g} vs float64", flush=True)
    del part, joined

    def run_join():
        return _join_path(fact, dim)

    torch.cuda.reset_peak_memory_stats()
    jwarm = _warm_stages(run_join)
    jpeak = torch.cuda.max_memory_allocated() / 2**30
    print("join path (host clock, ms): first run " + _fmt_stages(jstage) + "; warm median of 3 "
          + _fmt_stages(jwarm) + f"; peak device memory {jpeak:.2f} GiB", flush=True)
    jprofile = _profile_phase(run_join, top=14, watch=("partition_map_kernel",
                                                        "probe_paged_kernel", "groupby_"))
    paths["join"] = {**jstage, "warm": jwarm, "warm_end_to_end_ms": jwarm["end_to_end_ms"],
                     "fact_rows": FACT_ROWS, "dim_rows": DIM_ROWS, "partitions": PARTITIONS,
                     **jcheck, "table": jkernels["probe_paged"]["table"], "peak_gib": jpeak,
                     "launches": jlaunches, "profile": jprofile}

    del fact, dim, side_arrays
    torch.cuda.empty_cache()

    # -- the onehot path: B2's entry point -----------------------------------
    okeys_h, ovals_h = _onehot_inputs(SEED + 3)
    okeys, ovals = torch.from_numpy(okeys_h).cuda(), torch.from_numpy(ovals_h).cuda()
    print(f"onehot input: {ONEHOT_ROWS} INT64 keys in [-5, {NUM_KEYS + 5}), "
          f"{int((okeys_h >= 2**32).sum())} of them >= 2^32, float32 values", flush=True)
    okernels = _onehot_kernel_phase(okeys, ovals, rate)
    _print_kernels(okernels)

    def run_onehot():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = hk.groupby_sum_bounded(okeys, ovals, NUM_KEYS)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        return out, {"groupby_ms": ms, "end_to_end_ms": ms}

    (osums, ostage), olaunches = _run_counted(wrappers, run_onehot)
    print(f"onehot path launches: {olaunches}", flush=True)
    if olaunches["groupby_sum_bounded"] != 1:
        raise AssertionError("the onehot path did not launch groupby_sum_bounded once")
    # the path once more under the profiler: B2's kernel is all it puts on
    # the card, no fill and no copy. The tracer has missed a launch on rare
    # occasions, so up to three counted runs are traced: none may show any
    # other device work, and one must show B2's kernel alone.
    for attempt in range(1, 4):
        oacts, oprof_launches = _run_counted(wrappers, lambda: _device_activities(
            lambda: hk.groupby_sum_bounded(okeys, ovals, NUM_KEYS), warm=False))
        print(f"onehot path under the profiler (run {attempt}): {len(oacts)} device activities "
              f"{[(name[:80], us) for name, us in oacts]}, launches {oprof_launches}", flush=True)
        if oprof_launches["groupby_sum_bounded"] != 1 or any(
                "groupby_bounded_kernel" not in name for name, _ in oacts):
            raise AssertionError("one groupby_sum_bounded call enqueued other device work than "
                                 "its one kernel")
        if len(oacts) == 1:
            break
    else:
        raise AssertionError("the profiler never showed groupby_sum_bounded's one kernel")
    oerr = _check_onehot(okeys_h, ovals_h, osums)
    owarm = _warm_stages(run_onehot)
    print(f"onehot path checked against np.bincount in float64: max abs err {oerr:.3g}; host ms: "
          f"first run {_fmt_stages(ostage)}; warm median of 3 {_fmt_stages(owarm)}", flush=True)
    paths["onehot"] = {**ostage, "warm": owarm, "warm_end_to_end_ms": owarm["end_to_end_ms"],
                       "rows": ONEHOT_ROWS, "num_keys": NUM_KEYS, "max_abs_err": oerr,
                       "launches": olaunches, "device_activities": oacts,
                       "profiled_runs": attempt}
    del okeys, ovals, osums

    # -- the tpch path: q1 and q6 at TPC-H SF1's lineitem cardinality --------
    t0 = time.perf_counter()
    li = tpch.gen_lineitem(LINEITEM_ROWS, seed=SEED + 4)
    torch.cuda.synchronize()
    li_bytes = sum(c.data.numel() * c.data.element_size() for c in li.columns)
    print(f"tpch input: lineitem {LINEITEM_ROWS} rows x {li.num_columns} columns, {li_bytes} B, "
          f"made and uploaded in {time.perf_counter() - t0:.1f} s", flush=True)
    (tout, tstage), tlaunches = _run_counted(wrappers, lambda: _tpch_path(li))
    print(f"tpch path launches: {tlaunches}", flush=True)
    tcheck = _check_tpch(li, tout)
    print(f"tpch path checked against the exact rational oracle: q1 ({tcheck['q1_rows_kept']} rows "
          f"kept, counts {tcheck['q1_counts']}) sums and means bit-identical on the operator tier, "
          f"q1_fused bit-identical to it, q6 = q6_fused = {tcheck['q6_revenue']!r} "
          f"({tcheck['q6_rows_kept']} rows)", flush=True)
    del tout
    torch.cuda.reset_peak_memory_stats()
    twarm = _warm_stages(lambda: _tpch_path(li))
    tpeak = torch.cuda.max_memory_allocated() / 2**30
    q1_runs = [_q1_stages(li) for _ in range(4)]
    if not all(np.array_equal(a.view(np.uint8), b.view(np.uint8))
               for a, b in zip(_q1_dense(q1_runs[-1][0]).values(), _q1_dense(tpch.q1(li)).values())):
        raise AssertionError("the staged q1 differs from tpch.q1")
    q1_split = {k: float(np.median([r[1][k] for r in q1_runs[1:]])) for k in q1_runs[0][1]}
    q6_runs = [_q6_stages(li) for _ in range(4)]
    if q6_runs[-1][0] != tcheck["q6_revenue"]:
        raise AssertionError("the staged q6 differs from the exact oracle")
    q6_split = {k: float(np.median([r[1][k] for r in q6_runs[1:]])) for k in q6_runs[0][1]}
    print("tpch path (host clock, ms): first run " + _fmt_stages(tstage) + "; warm median of 3 "
          + _fmt_stages(twarm) + f"; peak device memory {tpeak:.2f} GiB; q1 stages: first "
          + _fmt_stages(q1_runs[0][1]) + ", warm median of 3 " + _fmt_stages(q1_split)
          + "; q6 stages: warm median of 3 " + _fmt_stages(q6_split), flush=True)
    reductions = _f64acc_reductions(li)
    print(f"f64acc at q1's shape ({reductions['rows']} rows, 6 segments), median of "
          f"{len(reductions['masked_turns_ms'])} turns: masked sums {reductions['masked_ms']:.3f} ms, "
          f"index_add_ {reductions['index_add_ms']:.3f} ms; index_add_ faster in "
          f"{reductions['index_add_faster_turns']} turns", flush=True)
    tprofile = _profile_phase(lambda: _tpch_path(li), top=14)
    paths["tpch"] = {**tstage, "warm": twarm, "warm_end_to_end_ms": twarm["end_to_end_ms"],
                     "q1_stages_first": q1_runs[0][1], "q1_stages_warm": q1_split,
                     "q6_stages_first": q6_runs[0][1], "q6_stages_warm": q6_split,
                     "rows": LINEITEM_ROWS, "input_bytes": li_bytes, **tcheck, "peak_gib": tpeak,
                     "f64acc_reductions": reductions, "launches": tlaunches, "profile": tprofile}
    del li, q1_runs, q6_runs
    torch.cuda.empty_cache()

    csrc = "spark_rapids_jni_tpu_torch/csrc/"
    sources = {"expand_u32_planes": csrc + "planes.cu", "pack_u8_planes": csrc + "planes.cu",
               "groupby_sum_outer": csrc + "groupby.cu", "rotl_take": csrc + "strings.cu",
               "var_accumulate": csrc + "strings.cu", "asm_epilogue": csrc + "strings.cu",
               "ragged_compact": csrc + "strings.cu", "partition_map": csrc + "partition.cu",
               "probe_paged": csrc + "join.cu", "groupby_sum_bounded": csrc + "groupby.cu"}
    replaces = {"expand_u32_planes": "spark_rapids_jni_tpu/ops/ragged_bytes.py:185",
                "pack_u8_planes": "spark_rapids_jni_tpu/ops/ragged_bytes.py:208",
                "groupby_sum_outer": "spark_rapids_jni_tpu/ops/pallas_kernels.py:416",
                "rotl_take": "spark_rapids_jni_tpu/ops/ragged_bytes.py:324",
                "var_accumulate": "spark_rapids_jni_tpu/ops/ragged_bytes.py:405",
                "asm_epilogue": "spark_rapids_jni_tpu/ops/ragged_bytes.py:465",
                "ragged_compact": "spark_rapids_jni_tpu/ops/pallas_kernels.py:927",
                "partition_map": "spark_rapids_jni_tpu/ops/pallas_kernels.py:178",
                "probe_paged": "spark_rapids_jni_tpu/ops/pallas_kernels.py:713",
                "groupby_sum_bounded": "spark_rapids_jni_tpu/ops/pallas_kernels.py:287"}
    # launches: the count on the path whose shapes the times are from
    # (B3/B6/B7 the fixed path, the string kernels the string path, B1/B4
    # the join path, B2 the onehot path)
    timed_on = {**{k: launches for k in kernels}, **{k: slaunches for k in skernels},
                **{k: jlaunches for k in jkernels}, **{k: olaunches for k in okernels}}
    line = {"kernels": [
        {"name": k, "route": "cuda", "source": sources[k], "replaces": replaces[k],
         "launches": timed_on[k][k],
         "launches_by_path": {"fixed": launches[k], "strings": slaunches[k], "join": jlaunches[k],
                              "onehot": olaunches[k], "tpch": tlaunches[k]},
         "max_abs_err": r["max_abs_err"], "ms": r["ms"], "kernel_ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"],
         **{x: r[x] for x in ("parts", "device_ms", "host_us", "library_host_us",
                              "max_abs_err_vs_b3") if x in r}}
        for k, r in {**kernels, **skernels, **jkernels, **okernels}.items()
    ], "paths": paths, "card": smi_line}
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                            "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
