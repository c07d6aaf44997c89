#!/usr/bin/env python3
"""Chip smoke for the PyTorch/H100 port (``spark_rapids_jni_tpu_torch``).

Builds the port's hand-written CUDA kernels from the sources in this
checkout (one nvcc per source, all at once), then on one card:

1. prints the card (``torch.cuda.get_device_name`` and nvidia-smi's name
   and power limit);
2. the FIXED path: holds B6, ``rows_to_planes`` (the decode's word
   planes straight from the row blob, B7's place on the path) and B3
   against their plain PyTorch versions at the shapes the path gives
   them, and B7 (``pack_u8_planes``) at function level on the byte planes
   of the same blob; times the kernel, the plain version and one library
   call computing the same function (CUDA events, warm-up, then the
   median of 10 launches, or of 30 turns with the library call), and drives the path
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
   about 1.3 KB a row. One run records the arguments the path hands
   ``extract_strings_many`` (every string column padded in one launch,
   B8's place on the encode's path), B9, B10 (``assemble_rows``, the
   blob's compaction from the padded rows), ``rows_to_planes`` (the
   decode's fixed sections by the row starts) and B5
   (``ragged_compact_many``, every string column's characters in one
   launch), and each is held against its plain version and timed on
   exactly those, the profiler's device time beside the events. The
   function-level kernels the path no longer launches -- B8
   (``rotl_take``), B7 and B10's ``asm_epilogue`` -- are held against
   their plain versions on the arguments the reference's composition
   builds from the same inputs, and each composition against what the
   path's kernel returned. The counted run then must launch the six
   kernels of the path (all but B3 once each) and neither B7 nor B8, and
   its rows, columns, offsets and chars are checked byte for byte;
4. the JOIN path, TPC-DS q3's shape (a fact batch against a dimension):
   a store_sales-like batch of 1,048,576 rows x 10 columns (INT32
   surrogate keys, INT32 quantity, FLOAT32 prices and profit, an INT64,
   a DECIMAL128; item_sk uniform in [0, 131,072) with 10% nulls, every
   third column nullable) and an item-like dimension of 65,536 rows
   (unique item_sk, i_brand_id in [0, 4096), i_manufact_id, two STRING
   columns of 1-50 bytes) through ``hash_partition(fact, 200,
   ["item_sk"])`` (B1) -> ``inner_join(.., dim, ["item_sk"])`` (the paged
   table and B4, then the gathers) -> ``groupby_sum_bounded(i_brand_id,
   ss_ext_sales_price, 4096)`` (B3). B1, B4 and B3 are held against their
   plain versions at the path's shapes (B4 also on INT64 copies of the
   keys, B3 on the joined INT32 brand keys; B4 and B3, as B3 on the
   fixed path's INT64 keys, timed in turns with their library calls; the
   host's enqueue time of each), one call of B3 must put exactly one
   kernel on the card on either path's keys (INT64 and INT32), the
   counted run must launch B1, B4 and B3, and the partition
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
7. the TPCDS path, BASELINE.json configs[2] and [3] and the rest of the
   single-chip TPC-DS family: the port's generators at the TPC-DS
   specification's fact-table cardinalities (store_sales 28,800,991 rows
   and web_sales 7,197,566 at SF10 for q3 and q95; 2,880,404 and 719,384
   at SF1 for q7, q19, q42, q52, q55, q94 and q98), dimensions at the
   generators' sizes, made on the host and uploaded. Each query runs once
   at its default parameters with every launch counter at 0 (the path runs
   none of the ten kernels: its joins are the pipeline's dense and
   sort-merge lookups and ``searchsorted`` semi/anti joins), and every
   result is held against a numpy oracle built over the surviving rows:
   group keys, order and counts exact, every sum, mean, ratio and total
   bit-identical to the exact rational (q94/q95 round each order's sum,
   then total the rounded sums exactly). Per query: first-run and warm
   median-of-3 host ms, peak memory, and a profile (device busy, idle
   share, launches, top device operations);
8. the SPARK_EXACT path, the reference's own Spark-exact operators at a
   Spark batch's 1,000,000 rows, made from the seed and uploaded through
   ``carry_table``: string -> INT64 / INT32 / UINT64 (integers uniform in
   [-10^8, 10^8) as the reference-shaped microbench's, with whitespace,
   '+' signs, non-ANSI truncation, every target's limit and limit + 1,
   invalid strings and nulls), then an ANSI cast that must raise CastError
   on its one bad row; string -> DECIMAL(38, 10) / (18, 4) / (9, 2) (1-38
   digits, exponents, more fractional digits than the scale);
   ``multiply128`` and ``divide128`` of DECIMAL(38, 10) operands to scale
   -6; ``interleave_bits`` over three INT32 range-id columns (nulls in
   one) and over four INT64 columns; and UINT32 / UINT64 expressions
   (``(u + 7) % 1000 > 3``, a narrowing cast). Both casts get their padded
   chars from ``extract_strings_many`` (B8's kernel), which the counted
   run must launch at least twice, and no other kernel. Every result is
   held against an independent oracle (Python ints transcribing
   dec128_multiplier / dec128_divider, Spark's rounding in Python ints,
   numpy's unsigned arithmetic, Delta's interleaveBits in numpy); per
   operation first-run and warm median-of-3 host ms, peak memory and a
   profile, and the phase's wall seconds;
9. the STRING_OPS path, the string and regex tier (``ops/utf8``,
   ``ops/strings``, ``ops/regex``) on a Spark batch of 1,000,000 rows made
   from the seed and uploaded through ``carry_table``: four STRING
   columns (emails of 8-40 bytes, ~2% without '@'; URLs of 20-80 bytes;
   multilingual text of 1-24 codepoints of 1-4 UTF-8 bytes with U+023A /
   U+2C65, ß, ΐ and edge spaces; comma lists of 0-8 fields of 0-6 bytes),
   each with 5% nulls and 1% empty strings, through ``length``, ASCII and
   Unicode ``upper`` / ``lower``, ``substring`` (positive, zero and
   negative starts), ``concat`` / ``concat_ws``, ``contains`` /
   ``startswith`` / ``endswith``, ``strip``, ``instr`` of a 2-byte needle,
   the UTF-8 decode -> encode round trip, ``contains_re`` / ``matches_re``,
   ``extract_re`` groups 0-2, ``split_re`` at limits -1, 3, 0 and
   ``replace_re``. The counted run records every call of B8's wrapper
   (``extract_strings_many``, ``strings.to_padded``) and of B5's
   (``ragged_compact_many``, ``strings.from_padded``): each is held bit for
   bit against its plain version, B8 must launch once a padding call with
   characters and B5 once a nonzero compaction, the other kernels never.
   Every result is held against a per-row host oracle (``bytes`` / ``str``
   methods, ``re`` under re.ASCII, Java's split), and the rows where
   Spark's semantics differ from the reference's (byte-counted length
   and substring, the 1:1 case map) are counted; per operation first-run
   and warm median-of-3 host ms, peak memory and a profile; B8 and B5
   timed at the path's shapes;
10. the IO path, a Spark scan: TPC-H SF1's lineitem (6,001,215 rows, not
   cut: ``gen_lineitem``'s seven columns and the specification's
   ``l_shipmode`` and ``l_comment``, made from the seed) written by the
   harness writers of ``tests/torch_io_writers.py`` as Parquet the way
   Spark's default write lays it out (128 MB row groups, ~1 MB v1 pages,
   dictionary where the distinct values fit 1 MB, SNAPPY with
   literal-only blocks, and once UNCOMPRESSED) and as ZLIB ORC (64 MB
   stripes), and a nested Parquet file of 1,000,000 rows (LIST<INT64> of
   0-8 elements, STRUCT<INT32, STRING>, 5% nulls at each level). Each
   file goes through ``parquet_footer.read_and_filter`` for every 128 MB
   split (the kept row groups must be those whose midpoint falls in the
   split, their rows summing to the file's), ``read_table`` onto the
   card (every column bit for bit the source arrays), and for lineitem
   ``convert_to_rows`` (the blob byte-identical to the rows of the same
   arrays uploaded directly; the counted run launches
   ``extract_strings_many``, ``var_accumulate`` and ``assemble_rows``
   once each and no other kernel, each call held bit for bit against its
   plain version) and ``frames.encode_table`` -> ``decode_table`` with
   checks on and off (bit-identical; one flipped payload byte raises
   ``DataCorruption``). Per file and stage: first-run and warm median-of-3
   host ms, GB/s, H2D copies and bytes, peak memory and a profile, and the
   native codec calls (the card host has no pyarrow);
11. prints one ``{"kernels": [...]}`` line (ten kernels) and, last, the
   ``{"ok": true, "device": {...}}`` line.

Any failed check raises and the script exits non-zero. Without a card,
or run from a directory without the port package, it exits non-zero
before printing any result.

Usage: ``python3 chip_smoke.py`` from the root of the checkout.
``python3 chip_smoke.py --kernels-only`` times B3, B1 and B4 alone on
the fixed and join paths' inputs (copy the script into another
checkout's root to time that checkout's wrappers the same way, as for a
checkout whose own script does not time their host work). It drives no
path, so it is a partial run: it prints its numbers, never the ``ok``
line, and exits 4.
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
FIXED_PATH_KERNELS = ("expand_u32_planes", "rows_to_planes", "groupby_sum_outer")
STRING_PATH_KERNELS = ("extract_strings_many", "var_accumulate", "assemble_rows", "rows_to_planes",
                       "ragged_compact_many", "groupby_sum_outer")
# launched exactly once by the string path: the extraction of all string
# columns, the blob's compaction, the decode's read of the fixed sections
# and its compaction of all string columns
STRING_PATH_ONCE = ("extract_strings_many", "assemble_rows", "rows_to_planes",
                    "ragged_compact_many")
# the function-level kernels of B7 and B8, which neither path launches
PATH_NEVER = ("pack_u8_planes", "rotl_take")
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


def _device_activities(fn, reps: int = 1, warm: bool = True, retake: bool = True):
    """The device activities (kernels, copies, fills) that ``reps`` calls
    of ``fn`` enqueue, as (name, us) from torch.profiler's CUDA activity,
    after one warm call unless ``warm`` is False. The tracer runs a
    warm-up step with one sleep kernel first, so the calls' first launch
    is not lost to its start; that marker is left out of the result.
    With ``retake``, a trace that records nothing is taken again (up to
    three traces), so every call of ``fn`` in the result is from one
    trace."""
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

    # a trace has on rare occasions come back with no device activity at
    # all: such a trace is taken again, twice at most
    for _ in range(3 if retake else 1):
        with profile(activities=[ProfilerActivity.CUDA], on_trace_ready=keep,
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            prof.step()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()
        if got:
            break
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


def _traced_ms(fn, kernel: str, launches: int, reps: int = 20) -> dict:
    """The device time of ``launches`` launches that each do what one call
    of ``fn`` does: the per-launch mean over the launches named like
    ``kernel`` that the tracer kept in ``reps`` calls, times ``launches``,
    with how many it kept beside. The tracer has kept none of a replay's
    launches on occasion (all 20 of a B5 replay once), so a replay that keeps none is
    traced again, twice at most; raises when three kept none (a wrong
    name, or a kernel that did not run)."""
    for attempt in range(1, 4):
        us = [t for name, t in _device_activities(fn, reps) if kernel in name]
        if us:
            break
        print(f"traced replay {attempt} kept no launch named like {kernel!r}", flush=True)
    if not us:
        raise AssertionError(f"the profiler recorded no device kernel named like {kernel!r}")
    return dict(device_ms=launches * float(np.mean(us)) / 1e3, device_traced=len(us),
                device_calls=reps, device_traces=attempt)


def _device_ms(fn, kernel: str, reps: int = 20) -> float:
    """Mean device time of the kernels named like ``kernel`` over ``reps``
    calls of ``fn``: the kernel alone, without the wrapper's host work that
    CUDA events around a call also take in. Raises when the profiler
    recorded no such kernel (a wrong name, or a kernel that did not run)."""
    return _traced_ms(fn, kernel, 1, reps)["device_ms"]


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
    for name in [*_build.SOURCES, *_build.HOST_SOURCES]:
        _build.library(name)
    print(f"build: {len(_build.SOURCES)} kernel libraries and {len(_build.HOST_SOURCES)} host "
          f"library ({', '.join(_build.HOST_SOURCES)}; zstd linked: {_build.zstd_probe()[0]}) in "
          f"{time.perf_counter() - t0:.1f} s ({_build.BUILD_DIR})", flush=True)


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
        device_ms=_device_ms(lambda: rb.expand_u32_planes(planes), "expand_kernel"),
        host_us=_host_us(lambda: rb.expand_u32_planes(planes)),
        bound_ms=nbytes / rate * 1e3, bound_by="bytes", shape=f"int32 [{p}, {n}] -> uint8 [{4 * p}, {n}]",
    )
    del got

    # rows_to_planes: the decode's word planes straight from the row blob
    # the encode makes of these planes (the uniform stride, W = the row)
    bplanes = want
    blob = bplanes.t().contiguous().reshape(-1)
    rs = 4 * p
    got = rb.rows_to_planes(blob, rs, rs, n)
    torch.cuda.synchronize()
    if not (torch.equal(got, rb.rows_to_planes_plain(blob, rs, rs, n)) and torch.equal(got, planes)):
        raise AssertionError("rows_to_planes disagrees with its plain version")

    def library():
        return blob.view(torch.int32).view(n, p).t().contiguous()

    if not torch.equal(library(), got):
        raise AssertionError("the library call computes another function than rows_to_planes")
    ms, library_ms = _time_turns([lambda: rb.rows_to_planes(blob, rs, rs, n), library])
    part = dict(
        launches=1, ms=ms, library_ms=library_ms,
        library="blob.view(int32).view(N, W/4).t().contiguous(), in turns with the kernel",
        device_ms=_device_ms(lambda: rb.rows_to_planes(blob, rs, rs, n), "rows_to_planes_kernel"),
        host_us=_host_us(lambda: rb.rows_to_planes(blob, rs, rs, n)),
        plain_ms=_time_ms(lambda: rb.rows_to_planes_plain(blob, rs, rs, n), reps=PLAIN_REPS, warm=1),
        # the blob read once, the planes written once
        bound_ms=nbytes / rate * 1e3)
    # B7, the function-level kernel, on the byte planes the reference's
    # composition builds from the same blob (its transpose)
    got7 = rb.pack_u8_planes(bplanes)
    want7 = rb.pack_u8_planes_plain(bplanes)
    torch.cuda.synchronize()
    if not (torch.equal(got7, want7) and torch.equal(got7, got)):
        raise AssertionError("pack_u8_planes disagrees with its plain version or rows_to_planes")
    b7 = dict(
        name="pack_u8_planes", shape=f"uint8 [{4 * p}, {n}] -> int32 [{p}, {n}]", max_abs_err=0.0,
        ms=_time_ms(lambda: rb.pack_u8_planes(bplanes)),
        device_ms=_device_ms(lambda: rb.pack_u8_planes(bplanes), "pack_kernel"),
        host_us=_host_us(lambda: rb.pack_u8_planes(bplanes)),
        plain_ms=_time_ms(lambda: rb.pack_u8_planes_plain(bplanes)),
        library_ms=_time_ms(
            lambda: bplanes.view(p, 4, n).permute(0, 2, 1).contiguous().view(torch.int32)),
        bound_ms=nbytes / rate * 1e3, bound_by="bytes")
    results["rows_to_planes"] = _combine(
        {f"fixed: uint8 blob [{n * rs}], stride {rs} -> int32 [{p}, {n}]": part},
        function_level=b7)
    del got, want, got7, want7, bplanes, planes, blob

    # B3: group-by over the key and value columns
    results["groupby_sum_outer"] = _b3_phase(table.columns[0].data, table.columns[1].data, rate)
    return results


def _one_activity(fn, kernel: str, wrapper) -> list:
    """The device activities of one call of ``fn`` under the profiler:
    ``kernel`` and nothing else, from one launch that ``wrapper`` counted.
    The tracer has missed a launch on rare occasions, so up to three calls
    are traced: none may show other device work or count other than one
    launch, and one must show the kernel alone."""
    for _ in range(3):
        wrapper.launches = 0
        acts = _device_activities(fn, warm=False, retake=False)
        if wrapper.launches != 1 or any(kernel not in name for name, _ in acts):
            raise AssertionError(f"one call enqueued other device work than {kernel}: "
                                 f"{[name[:80] for name, _ in acts]}, {wrapper.launches} launches")
        if len(acts) == 1:
            return acts
    raise AssertionError(f"the profiler never showed {kernel} alone")


def _b3_phase(keys, vals, rate: float, check_one: bool = True):
    """B3 against its plain version on one path's keys and values, timed
    in turns with its library call (30 rounds: a few microseconds of
    device work behind the host's), with the profiler's device time (the
    kernel, by whatever name the checkout's wrapper launches, and all the
    device work of a call) and the host's enqueue time. With
    ``check_one``, one call must put exactly one kernel on the card."""
    import torch
    from spark_rapids_jni_tpu_torch.ops import hopper_kernels as hk

    gs, gc = hk.groupby_sum_outer(keys, vals, NUM_KEYS)
    ws, wc = hk.groupby_sum_outer_plain(keys, vals, NUM_KEYS)
    torch.cuda.synchronize()
    if not torch.equal(gc, wc):
        raise AssertionError("groupby_sum_outer counts disagree with its plain version")
    if not torch.allclose(gs, ws, rtol=RTOL, atol=ATOL):
        raise AssertionError("groupby_sum_outer sums disagree with its plain version")
    k64 = keys.to(torch.int64)  # the library call's index: built outside the timed region

    def call():
        return hk.groupby_sum_outer(keys, vals, NUM_KEYS)

    def library():
        s = torch.zeros(NUM_KEYS, dtype=torch.float32, device=keys.device).index_add_(0, k64, vals)
        return s, torch.bincount(k64, minlength=NUM_KEYS)

    n = keys.shape[0]
    acts = _device_activities(call, reps=20)
    ms, library_ms = _time_turns([call, library])
    out = dict(
        max_abs_err=float((gs - ws).abs().max()),
        ms=ms,
        device_ms=_device_ms(call, "groupby_"),
        device_call_ms=sum(t for _, t in acts) / 20 / 1e3,
        activities_per_call=len(acts) / 20,
        host_us=_host_us(call),
        plain_ms=_time_ms(lambda: hk.groupby_sum_outer_plain(keys, vals, NUM_KEYS)),
        library_ms=library_ms, library="index_add_ + bincount, in turns with the kernel",
        # reads the key (4 or 8 B) and the f32 value a row, writes 12 B a
        # key (f32 sum, int64 count); one add a row is far below the f32 rate
        bound_ms=((keys.element_size() + 4) * n + 12 * NUM_KEYS) / rate * 1e3, bound_by="bytes",
        shape=f"{str(keys.dtype).replace('torch.', '')} [{n}] keys, float32 [{n}] values, "
              f"K={NUM_KEYS}",
    )
    if check_one:
        out["one_call_activities"] = [(name[:80], us) for name, us in
                                      _one_activity(call, "groupby_outer_kernel", hk.groupby_sum_outer)]
    return out


def _profile_phase(run_path, top: int = 8, watch=None):
    """One warm main-path run under torch.profiler: device busy time by
    kernel and by aten op, and the device's idle share of the host window.
    ``watch`` maps a kernel's name to the wrapper that launches it: those
    kernels are printed whatever their rank, their device ms land in the
    result's ``watched`` and their (traced, launched) counts in
    ``watched_traced``, and the trace must hold each as many times as
    its wrapper counted in the traced run. As in ``_device_activities``,
    a warm-up step with one sleep kernel comes first. The tracer has
    dropped part of a run on rare occasions (a join-path trace once held
    221 of its 281 launches, B1's among the lost), so a trace that holds
    no device work or is short of a watched kernel is taken again, twice
    at most; a third short one is recorded as such (``short_of``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    watch = watch or {}
    run_path()
    torch.cuda.synchronize()
    for attempt in range(1, 4):
        for w in watch.values():
            w.launches = 0
        got = {}

        def keep(prof):
            # the step's own span shows on the device too: left out, as the
            # warm-up's sleep kernel is
            got["events"] = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                             if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.name
                             and not e.name.startswith("ProfilerStep")]
            got["ops"] = sorted(
                ((a.key, a.device_time_total, a.count) for a in prof.key_averages()
                 if a.device_type == DeviceType.CPU and a.key.startswith("aten::")
                 and a.device_time_total > 0), key=lambda x: -x[1])

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], on_trace_ready=keep,
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            prof.step()
            t0 = time.perf_counter()
            run_path()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            prof.step()
        events = got.get("events", [])
        traced = {k: (sum(k in name for name, _, _ in events), w.launches) for k, w in watch.items()}
        short = {k: v for k, v in traced.items() if v[0] != v[1]}
        if events and not short:
            break
        print(f"profile (trace {attempt}): {len(events)} device activities; watched kernels "
              f"traced / launched where they differ: {short}", flush=True)
    if not events:
        print("profile: the profiler recorded no device time (not measured)", flush=True)
        return None
    spans, by_kernel = [], {}
    for name, start, end in events:
        spans.append((start, end))
        us, cnt = by_kernel.get(name, (0.0, 0))
        by_kernel[name] = (us + end - start, cnt + 1)
    busy_us, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            busy_us += e - max(s, end)
            end = e
    print(f"profile: device busy {busy_us / 1e3:.2f} ms of a {wall_ms:.2f} ms host window "
          f"(idle share {1 - busy_us / 1e3 / wall_ms:.3f}), {len(spans)} kernel launches, "
          f"trace {attempt}" + (f", short of watched kernels {short}" if short else ""), flush=True)
    for name, (us, cnt) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"profile kernel: {us / 1e3:9.3f} ms x{cnt:<4d} {name[:110]}", flush=True)
    for name, us, cnt in got["ops"][:top]:
        print(f"profile op (incl. children): {us / 1e3:9.3f} ms x{cnt:<4d} {name}", flush=True)
    watched = {}
    for w in watch:
        hits = [(name, us, cnt) for name, (us, cnt) in by_kernel.items() if w in name]
        watched[w] = sum(us for _, us, _ in hits) / 1e3
        for name, us, cnt in hits:
            print(f"profile kernel (watched): {us / 1e3:9.4f} ms x{cnt:<4d} {name[:110]}", flush=True)
    return {"device_busy_ms": busy_us / 1e3, "host_window_ms": wall_ms,
            "idle_share": 1 - busy_us / 1e3 / wall_ms, "kernel_launches": len(spans),
            "watched": watched, "watched_traced": traced, "traces": attempt, "short_of": short}


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
    """Run ``run`` once with the wrappers of the string path's kernels --
    ``extract_strings_many`` (B8 on the encode's path), B9, B10
    (``assemble_rows``), ``rows_to_planes`` (B7 with B8's gather on the
    decode's path) and B5 (``ragged_compact_many``) -- recording the
    arguments the path hands them, and restore the wrappers. Returns
    {kernel: [(wrapper, args, kwargs), ...]}."""
    from spark_rapids_jni_tpu_torch.ops import hopper_kernels as hk
    from spark_rapids_jni_tpu_torch.ops import row_conversion as rc

    names = ("extract_strings_many", "var_accumulate", "assemble_rows", "rows_to_planes")
    seen = {k: [] for k in names + ("ragged_compact_many",)}
    sites = [(rc, k, k) for k in names] + [(hk, "ragged_compact_many", "ragged_compact_many")]
    originals = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in sites]

    def recorder(fn, key):
        def call(*args, **kwargs):  # kwargs: only B5's row_starts
            seen[key].append((fn, args, kwargs))
            return fn(*args, **kwargs)
        # the capture run's launches land on the wrappers' counts, or on this
        # one where a wrapper counts through its module-level name (B5); the
        # counted runs set every count to 0 first
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


def _combine(parts, **extra):
    """One kernel's entry from its parts (one a shape or a path): times,
    bounds and launches summed; the library time where every part has
    one; the host time a call the parts' mean."""
    out = {k: sum(p[k] for p in parts.values()) for k in ("ms", "plain_ms", "bound_ms")}
    libs = [p.get("library_ms") for p in parts.values()]
    out["library_ms"] = None if None in libs else sum(libs)
    for k in ("launches", "device_ms"):
        if all(k in p for p in parts.values()):
            out[k] = sum(p[k] for p in parts.values())
    if all("host_us" in p for p in parts.values()):
        out["host_us"] = float(np.mean([p["host_us"] for p in parts.values()]))
    return dict(out, max_abs_err=0.0, bound_by="bytes", parts=parts, **extra)


def _string_kernel_phase(seen, rate: float):
    """Each string kernel against its plain version on the arguments the
    string path gave it, and its times summed over the path's launches
    (CUDA events around all of a shape's launches; ``parts`` splits them
    by shape; "device" the profiler's kernel time, per launch times the
    launches). The function-level kernels the path no longer launches are
    held against their plain versions on the arguments the reference's
    composition builds from the path's own: B8 (``rotl_take``) on the
    overlapping tiles of every string column and of the decode's fixed
    sections, B7 (``pack_u8_planes``) on the byte planes of those sections,
    B10's ``asm_epilogue`` on the reference's tiles; each composition must
    equal what the path's kernel returned. B10's row also times the blob's
    compaction from the padded rows concatenated first (the other way to
    read them)."""
    import torch
    from spark_rapids_jni_tpu_torch.ops import hopper_kernels as hk
    from spark_rapids_jni_tpu_torch.ops import ragged_bytes as rb
    from spark_rapids_jni_tpu_torch.ops import uword

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

    results = {}
    b8_calls = []  # B8's calls in the reference's composition: (wrapper, tiles, shifts, out_w)

    # rows_to_planes: the decode's fixed sections, from the blob by the row
    # starts, once
    (fn, (blob, starts, width), _), = seen["rows_to_planes"]
    n, p = starts.shape[0], (width + 3) // 4
    got, want = fn(blob, starts, width), rb.rows_to_planes_plain(blob, starts, width)
    # the reference's composition: the tile gather and B8, then B7 on the
    # byte planes of the first W bytes
    tiles, sh, stride = rb.extract_tiles(blob, starts, width)
    b8_calls.append((rb.rotl_take32 if tiles.dtype == torch.int32 else rb.rotl_take, tiles, sh,
                     stride))
    fixed = torch.nn.functional.pad(b8_calls[0][0](tiles, sh, stride)[:, :width], (0, (-width) % 4))
    bplanes = fixed.t().contiguous()
    del fixed
    comp, comp_plain = rb.pack_u8_planes(bplanes), rb.pack_u8_planes_plain(bplanes)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("rows_to_planes disagrees with its plain version")
    if not (torch.equal(comp, comp_plain) and torch.equal(comp, got)):
        raise AssertionError("rows_to_planes differs from the reference's composition "
                             "(tile gather, B8, transpose, B7), or B7 from its plain version")
    del bplanes, comp, comp_plain, want
    # no one call computes it; the index gather of every row's bytes and
    # one transpose, with the index (bytes past W or the blob on an
    # appended zero) built outside the timed region, stand beside it
    blen = blob.shape[0]
    blob0 = torch.cat([blob, blob.new_zeros(1)])
    span = torch.arange(4 * p, device=blob.device)
    idx = starts[:, None] + span
    idx = torch.where((span < width) & (idx < blen), idx, blen)

    def gather_transpose():
        return blob0[idx].view(torch.int32).t().contiguous()

    if not torch.equal(gather_transpose(), got):
        raise AssertionError("the index gather and transpose compute another function")
    part = dict(
        launches=1, ms=_time_ms(lambda: fn(blob, starts, width)),
        device_ms=_device_ms(lambda: fn(blob, starts, width), "rows_to_planes_kernel"),
        host_us=_host_us(lambda: fn(blob, starts, width), reps=10),
        plain_ms=_time_ms(lambda: rb.rows_to_planes_plain(blob, starts, width), reps=PLAIN_REPS,
                          warm=1),
        library_ms=None, library="none: no one PyTorch call gathers rows at ragged starts into "
                                 "word planes",
        gather_transpose_ms=_time_ms(gather_transpose, reps=PLAIN_REPS, warm=1),
        # the rows' first W bytes read, the planes written, the starts
        bound_ms=(n * width + 4 * p * n + 8 * n) / rate * 1e3)
    results["rows_to_planes"] = _combine({
        f"strings: uint8 blob [{blen}], {n} int64 row starts, W {width} -> int32 [{p}, {n}]": part})
    del got, blob0, idx, tiles, sh

    # extract_strings_many: every string column of the encode, once
    (fn, (pools, starts, lens, widths), _), = seen["extract_strings_many"]
    n = starts[0].shape[0]
    got, want = fn(pools, starts, lens, widths), rb.extract_strings_many_plain(pools, starts, lens,
                                                                               widths)
    torch.cuda.synchronize()
    if len(got) != len(want) or not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("extract_strings_many disagrees with its plain version")
    del want
    # the reference's composition: per column the tile gather and B8 at the
    # column's width, masked by the lengths
    for pool, st, ln, lc, g in zip(pools, starts, lens, widths, got):
        tiles, sh, stride = rb.extract_tiles(pool, st, lc)
        b8 = rb.rotl_take32 if tiles.dtype == torch.int32 else rb.rotl_take
        b8_calls.append((b8, tiles, sh, stride))
        keep = torch.arange(lc, device=pool.device)[None, :] < ln[:, None]
        if not torch.equal(torch.where(keep, b8(tiles, sh, stride)[:, :lc], 0), g):
            raise AssertionError("extract_strings_many differs from the reference's composition "
                                 "(tile gather, B8, length mask)")
    # the library yardstick: one gather a column over the pool with a zero
    # byte appended, masked bytes indexing that zero; the index and the
    # pool's copy made outside the timed region
    ext, idxs = [], []
    for pool, st, ln, lc in zip(pools, starts, lens, widths):
        plen = pool.shape[0]
        span = torch.arange(lc, device=pool.device)
        i = st.to(torch.int64)[:, None] + span
        idxs.append(torch.where((span < ln.to(torch.int64)[:, None]) & (i < plen), i, plen))
        ext.append(torch.cat([pool, pool.new_zeros(1)]))

    def library():
        return [e[i] for e, i in zip(ext, idxs)]

    if not all(torch.equal(a, b) for a, b in zip(library(), got)):
        raise AssertionError("the per-column gathers compute another function")
    ms, library_ms = _time_turns([lambda: fn(pools, starts, lens, widths), library])
    str_bytes = sum(int(torch.clamp(ln.to(torch.int64), 0, lc).sum())
                    for ln, lc in zip(lens, widths))
    results["extract_strings_many"] = dict(
        launches=1, max_abs_err=0.0, bound_by="bytes",
        shape=f"{len(pools)} columns, uint8 [{n}, {'/'.join(str(w) for w in sorted(set(widths)))}]",
        ms=ms, library_ms=library_ms,
        library="per column ext[idx] (the pool with a zero byte appended), index and copy built "
                "outside the timed region, summed over the columns, in turns with the kernel",
        device_ms=_device_ms(lambda: fn(pools, starts, lens, widths), "extract_strings_kernel"),
        host_us=_host_us(lambda: fn(pools, starts, lens, widths), reps=10),
        plain_ms=_time_ms(lambda: rb.extract_strings_many_plain(pools, starts, lens, widths),
                          reps=PLAIN_REPS, warm=1),
        # the strings' bytes up to each width read, int32 starts and
        # lengths, every column's [N, width] written
        bound_ms=(str_bytes + sum(8 * n + n * lc for lc in widths)) / rate * 1e3)
    del got, ext, idxs

    # B8 at function level: on the reference's tiles of the decode's fixed
    # sections and of every string column
    groups = {}
    for b8, x, sh, out_w in b8_calls:
        groups.setdefault((tuple(u8(x).shape), out_w), []).append((b8, x, sh, out_w))
    parts = {}
    for (shape, out_w), calls in groups.items():
        parts[f"uint8 [{shape[0]}, {shape[1]}] -> [{shape[0]}, {out_w}]"] = measure(
            [c[1:] for c in calls], calls[0][0],
            lambda x, sh, w: rb.rotl_take_plain(u32(x), sh, w),
            lambda x, sh, w: torch.gather(
                u8(x), 1, (torch.arange(w, device=x.device)[None, :] + sh[:, None]) % u8(x).shape[1]),
            # the window's bytes, the shift, the output
            lambda x, sh, w: x.shape[0] * (2 * w + 4),
        )
    results["extract_strings_many"]["function_level"] = dict(
        _combine(parts, library="torch.gather with its index built in the timed region"),
        name="rotl_take", shape="; ".join(parts),
        device_ms=_device_ms(lambda: [c[0](*c[1:]) for c in b8_calls], "rotl_take_kernel")
        * len(b8_calls),
        host_us=_host_us(lambda: b8_calls[-1][0](*b8_calls[-1][1:]), reps=10))
    del b8_calls, groups

    # B9: the variable sections, once
    parts = {}
    for fn, (mats, shifts, maxvar), _ in seen["var_accumulate"]:
        n = mats[0].shape[0]
        parts[f"{len(mats)} x uint8 [{n}, <= {max(m.shape[1] for m in mats)}] -> "
              f"[{n}, {maxvar}]"] = measure(
            [(mats, shifts, maxvar)], fn, rb.var_accumulate_plain, None,
            lambda m, s, w: sum(x.numel() for x in m) + 4 * n * len(m) + n * w)
    results["var_accumulate"] = _combine(
        parts, library="none: no one call ORs K byte-shifted matrices into one",
        device_ms=sum(_device_ms(lambda: fn(*args), "var_accumulate_tile_kernel")
                      for fn, args, _ in seen["var_accumulate"]),
        host_us=sum(_host_us(lambda: fn(*args), reps=10) for fn, args, _ in seen["var_accumulate"]))

    # B10: the blob's compaction from the padded rows, once
    parts, extra = {}, {}
    for fn, args, _ in seen["assemble_rows"]:
        rp_parts, sizes, offsets, total, min_row = args
        n = sizes.shape[0]
        rows_u8 = torch.cat(list(rp_parts), dim=1).view(torch.uint8)  # the library's input

        def library(rp_parts, sizes, offsets, total, min_row, rows_u8=rows_u8):
            r = torch.arange(sizes.shape[0], device=sizes.device) * rows_u8.shape[1]
            idx = torch.repeat_interleave(r - offsets[:-1], sizes, output_size=total)
            return rows_u8.view(-1)[idx + torch.arange(total, device=sizes.device)]

        parts[f"{len(rp_parts)} parts " + " + ".join(
            f"int32 [{p.shape[0]}, {p.shape[1]}]{' (transposed view)' if p.stride(0) == 1 else ''}"
            for p in rp_parts) + f" -> uint8 [{total}]"] = measure(
            [args], fn, rb.assemble_rows_plain, library,
            # the output's bytes read from the rows and written, the offsets
            lambda p, s, o, t, m: 2 * t + 8 * (s.shape[0] + 1))
        got_cat = fn([torch.cat(list(rp_parts), dim=1)], sizes, offsets, total, min_row)
        if not torch.equal(got_cat, fn(*args)):
            raise AssertionError("assemble_rows reads concatenated rows otherwise than their parts")
        extra["layouts_ms"] = {
            "parts_as_the_path_gives_them": _time_ms(lambda: fn(*args)),
            "concatenated_first_cat_included": _time_ms(lambda: fn(
                [torch.cat(list(rp_parts), dim=1)], sizes, offsets, total, min_row))}
        extra["device_ms"] = _device_ms(lambda: fn(*args), "assemble_rows_kernel")
        extra["host_us"] = _host_us(lambda: fn(*args), reps=10)
        del rows_u8, got_cat
        # the function-level B10 kernel on the tiles the plain composition builds
        tiles = rb.assemble_tiles(*args)
        got, want = rb.asm_epilogue(*tiles), rb.asm_epilogue_plain(*tiles)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError("asm_epilogue disagrees with its plain version")
        t, g = tiles[0].shape[0], tiles[-1]
        extra["function_level"] = dict(
            name="asm_epilogue", shape=f"3 x int32 [{t}, {g // 4}] -> [{t}, {g // 4}]",
            max_abs_err=0.0, ms=_time_ms(lambda: rb.asm_epilogue(*tiles)),
            device_ms=_device_ms(lambda: rb.asm_epilogue(*tiles), "asm_epilogue_kernel"),
            plain_ms=_time_ms(lambda: rb.asm_epilogue_plain(*tiles), reps=PLAIN_REPS, warm=1),
            # G source bytes a tile (alen from the window, the rest from the
            # next row's head), three scalars, G bytes out
            bound_ms=t * (2 * g + 12) / rate * 1e3, bound_by="bytes")
        del tiles, got, want
    results["assemble_rows"] = _combine(
        parts, library="rows_u8.view(-1)[repeat_interleave(r * S - offsets[:-1], sizes) + "
                       "arange(total)], index built in the timed region, the padded rows "
                       "concatenated outside it", **extra)

    # B5: every string column's compaction out of the one row blob, one launch
    (fn, (pool, columns), kwargs), = seen["ragged_compact_many"]
    starts = kwargs["row_starts"]
    pool32 = rb.build_pool32(pool)  # the plain version's word view, once per blob

    def plain(pool, columns):
        return [hk.ragged_compact_plain(pool, starts + uword.u32_to_i64(b), o, t, pool32=pool32)
                for b, o, t in columns]

    def library(pool, columns):
        out = []
        for b, o, t in columns:
            base = starts + uword.u32_to_i64(b)
            o = o.to(torch.int64)
            idx = torch.repeat_interleave(base - o[:-1], o[1:] - o[:-1], output_size=t)
            out.append(pool[idx + torch.arange(t, device=pool.device)])
        return out

    def b5(pool, columns):
        return fn(pool, columns, row_starts=starts)

    got, want = b5(pool, columns), plain(pool, columns)
    torch.cuda.synchronize()
    if len(got) != len(want) or not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("ragged_compact_many disagrees with its plain version")
    del got, want
    n = starts.shape[0]
    totals = [int(t) for _, _, t in columns]
    results["ragged_compact_many"] = dict(
        launches=1, max_abs_err=0.0, bound_by="bytes",
        shape=f"{len(columns)} columns of uint8 blob [{pool.shape[0]}] -> {sum(totals)} B",
        ms=_time_ms(lambda: b5(pool, columns)),
        device_ms=_device_ms(lambda: b5(pool, columns), "ragged_compact_rows_kernel"),
        host_us=_host_us(lambda: b5(pool, columns), reps=10),
        plain_ms=_time_ms(lambda: plain(pool, columns), reps=PLAIN_REPS, warm=1),
        library_ms=_time_ms(lambda: library(pool, columns), reps=PLAIN_REPS, warm=1),
        library="per column pool[repeat_interleave(starts + slot - offs[:-1], lens) + "
                "arange(total)], index built in the timed region",
        # the row starts once; a column's int32 slot offsets and offsets,
        # its bytes read and written
        bound_ms=(8 * n + sum(4 * n + 4 * (n + 1) + 2 * t for t in totals)) / rate * 1e3,
        # the per-column kernel's inputs: an int64 base and int64 offsets a column
        bound_ms_int64_base=sum(2 * t + 8 * n + 8 * (n + 1) for t in totals) / rate * 1e3)
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


def _join_kernel_phase(fact, part, dim, rate: float, check_one: bool = True):
    """B1, B4 and B3 against their plain versions at the join path's
    shapes: B1 on the fact batch's key column, B4 on the partitioned key
    column against the dimension's table (once more on INT64 copies of
    both, the 64-bit route), B3 on the joined brand keys and prices."""
    import torch
    from spark_rapids_jni_tpu_torch.ops import hopper_kernels as hk
    from spark_rapids_jni_tpu_torch.ops import join
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
        host_us=_host_us(lambda: hk.partition_map(key.data, PARTITIONS, key.validity)),
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
    ms, library_ms = _time_turns([lambda: hk.probe_paged(pkey.data, pkey.validity, tab),
                                  lambda: (torch.searchsorted(comp, pcomp, side="left"),
                                           torch.searchsorted(comp, pcomp, side="right"))])
    results["probe_paged"] = dict(
        max_abs_err=0.0,
        ms=ms,
        device_ms=_device_ms(lambda: hk.probe_paged(pkey.data, pkey.validity, tab), "probe_"),
        host_us=_host_us(lambda: hk.probe_paged(pkey.data, pkey.validity, tab)),
        plain_ms=_time_ms(lambda: hk.probe_paged_plain(pkey.data, pkey.validity, tab)),
        library_ms=library_ms,
        library="two torch.searchsorted over the sorted int64 (bucket << 32 | order word) "
                "of the build side, composites built outside the timed region, in turns "
                "with the kernel",
        # 4 B key + 1 B validity in, 8 B (lo, eq) out a row; the table once
        bound_ms=(13 * n + table_bytes) / rate * 1e3, bound_by="bytes",
        shape=f"int32 [{n}] keys + validity vs {tab.nm} build rows, {tab.n_pages} pages",
        table={"num_buckets": tab.num_buckets, "n_pages": tab.n_pages, "c_max": tab.c_max,
               "nm": tab.nm, "fence_stride": getattr(tab, "fence_stride", None)},
    )
    # B3 on the path's own group-by input: the joined INT32 brand keys
    joined = join.inner_join(part, dim, ["item_sk"])
    results["groupby_sum_outer"] = _b3_phase(joined.column("i_brand_id").data,
                                             joined.column("ss_ext_sales_price").data, rate,
                                             check_one=check_one)
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


# ---------------------------------------------------------------------------
# the tpcds path
# ---------------------------------------------------------------------------

# fact-table rows: the TPC-DS specification's store_sales and web_sales
# cardinalities at scale factors 10 and 1
TPCDS_ROWS = {"store10": 28_800_991, "web10": 7_197_566, "store1": 2_880_404, "web1": 719_384}
# (query, star): q3 and q95 at SF10 (BASELINE.json configs[2] and [3]), the rest at SF1
TPCDS_QUERIES = (("q3", "store10"), ("q95", "web10"), ("q7", "wide1"), ("q19", "wide1"),
                 ("q42", "store1"), ("q52", "store1"), ("q55", "store1"), ("q94", "web1"),
                 ("q98", "store1"))


def _tpcds_inputs(device=None):
    """The stars, made on the host by the port's generators and uploaded;
    dimensions at the generators' sizes."""
    from spark_rapids_jni_tpu_torch.models import tpcds

    return {"store10": tpcds.gen_store(TPCDS_ROWS["store10"], seed=SEED + 5, device=device),
            "web10": tpcds.gen_web(TPCDS_ROWS["web10"], seed=SEED + 8, device=device),
            "store1": tpcds.gen_store(TPCDS_ROWS["store1"], seed=SEED + 6, device=device),
            "wide1": tpcds.gen_store_wide(TPCDS_ROWS["store1"], seed=SEED + 7, device=device),
            "web1": tpcds.gen_web(TPCDS_ROWS["web1"], seed=SEED + 9, device=device)}


def _tpcds_query(q: str, stars):
    import torch
    from spark_rapids_jni_tpu_torch.models import tpcds

    star = dict(TPCDS_QUERIES)[q]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = getattr(tpcds, q)(stars[star])
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _tpcds_path(stars):
    """Every query once with its default parameters; host ms of each,
    each ending in a synchronize."""
    out, stage = {}, {}
    for q, _ in TPCDS_QUERIES:
        out[q], stage[f"{q}_ms"] = _tpcds_query(q, stars)
    stage["end_to_end_ms"] = sum(stage.values())
    return out, stage


def _host_star(star):
    """Host arrays of a star's tables (FLOAT64 as float64, integers as
    int64); every dimension's surrogate key must be 0..n-1, so a foreign
    key indexes its dimension's arrays directly."""
    h = {}
    for tname, t in star.items():
        h[tname] = {n: c.to_numpy().view(np.float64) if c.dtype.id.name == "FLOAT64"
                    else c.to_numpy().astype(np.int64) for n, c in zip(t.names, t.columns)}
    for tname, key in (("date_dim", "d_date_sk"), ("item", "i_item_sk"),
                       ("customer_demographics", "cd_demo_sk"), ("promotion", "p_promo_sk"),
                       ("customer", "c_customer_sk"), ("customer_address", "ca_address_sk"),
                       ("store", "s_store_sk")):
        if tname in h and not np.array_equal(h[tname][key], np.arange(h[tname][key].shape[0])):
            raise AssertionError(f"{tname}.{key} is not 0..n-1")
    return h


def _exact_groups(x: np.ndarray, keys):
    """Groups of the rows by ``keys`` (unique key rows in lexicographic
    order), exact sums of ``x`` per group as (numerators, exponent) and
    the row counts."""
    if x.shape[0] == 0:
        return [np.zeros(0, np.int64) for _ in keys], [], 0, np.zeros(0, np.int64)
    uniq, inv = np.unique(np.stack(keys, axis=1), axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    nums, e0 = _exact_sums(x, inv, uniq.shape[0])
    return ([uniq[:, i] for i in range(len(keys))], nums, e0,
            np.bincount(inv, minlength=uniq.shape[0]))


def _rounded(nums, e0, counts=None) -> np.ndarray:
    """The nearest float64 of each exact sum (or mean, over ``counts``)."""
    if counts is None:
        return np.array([_frac_float(v, e0) for v in nums], dtype=np.float64)
    return np.array([_frac_float(v, e0, int(c)) for v, c in zip(nums, counts)], dtype=np.float64)


def _star_sales(h, keep_fn, key_fn):
    """``_exact_groups`` of store_sales' ss_ext_sales_price over the rows
    ``keep_fn`` keeps, grouped by the keys ``key_fn`` gives for them."""
    ss = h["store_sales"]
    keep = keep_fn(ss)
    return _exact_groups(ss["ss_ext_sales_price"][keep], key_fn(ss, keep))


def _tpcds_oracle(q: str, h) -> dict:
    """The numpy oracle of query ``q`` at its default parameters over the
    host arrays ``h`` of its star: result columns (or q94/q95's scalars),
    every float the nearest float64 of the exact rational."""
    if q in ("q94", "q95"):
        ws, lo, hi = h["web_sales"], 400, 460
        o, w, ship = ws["ws_order_number"], ws["ws_warehouse_sk"], ws["ws_ship_date_sk"]
        n_orders = int(o.max()) + 1
        wmin = np.full(n_orders, np.iinfo(np.int64).max)
        wmax = np.full(n_orders, np.iinfo(np.int64).min)
        np.minimum.at(wmin, o, w)
        np.maximum.at(wmax, o, w)
        returned = np.zeros(n_orders, bool)
        returned[h["web_returns"]["wr_order_number"]] = True
        keep = (ship >= lo) & (ship <= hi) & (wmin != wmax)[o]
        keep &= returned[o] if q == "q95" else ~returned[o]
        res = {"order_count": int(np.unique(o[keep]).shape[0])}
        for out, src in (("total_shipping_cost", "ws_ext_ship_cost"),
                         ("total_net_profit", "ws_net_profit")):
            _, nums, e0, _ = _exact_groups(ws[src][keep], [o[keep]])
            per_order = _rounded(nums, e0)  # each order's sum rounded first
            tot, te0 = _exact_sums(per_order, np.zeros(per_order.shape[0], np.int64), 1)
            res[out] = _frac_float(tot[0], te0)
        return res

    dd, it = h["date_dim"], h["item"]
    if q == "q3":  # manufact 128, month 11
        (y, b), nums, e0, _ = _star_sales(
            h, lambda ss: ((dd["d_moy"][ss["ss_sold_date_sk"]] == 11)
                           & (it["i_manufact_id"][ss["ss_item_sk"]] == 128)),
            lambda ss, k: [dd["d_year"][ss["ss_sold_date_sk"][k]],
                           it["i_brand_id"][ss["ss_item_sk"][k]]])
        s = _rounded(nums, e0)
        o = np.lexsort((b, -s, y))
        return {"d_year": y[o], "i_brand_id": b[o], "ss_ext_sales_price_sum": s[o]}
    if q in ("q42", "q52", "q55", "q98"):
        mgr, month, year = {"q55": (28, 11, 1999)}.get(q, (1, 11, 2000))

        def when(ss):
            d = ss["ss_sold_date_sk"]
            k = (dd["d_moy"][d] == month) & (dd["d_year"][d] == year)
            return k if q == "q98" else k & (it["i_manager_id"][ss["ss_item_sk"]] == mgr)

        key = {"q42": ["i_category_id"], "q98": ["i_category_id", "i_brand_id"]}.get(
            q, ["i_brand_id"])
        keys, nums, e0, _ = _star_sales(
            h, when, lambda ss, k: [it[c][ss["ss_item_sk"][k]] for c in key])
        s = _rounded(nums, e0)
        if q == "q98":
            cat, brand = keys
            (cats,), tnums, te0, _ = _exact_groups(s, [cat])  # the window's exact sum
            tot = _rounded(tnums, te0)[np.searchsorted(cats, cat)]
            ratio = (s * 100.0) / tot
            o = np.lexsort((brand, ratio, cat))
            return {"i_category_id": cat[o], "i_brand_id": brand[o], "itemrevenue": s[o],
                    "revenueratio": ratio[o]}
        k = keys[0]
        if q == "q55":
            o = np.lexsort((k, -s))
            return {"i_brand_id": k[o], "ext_price": s[o]}
        o = np.lexsort((k, -s))  # q42: ext_price desc, (d_year), key; q52: (d_year), desc, key
        return {"d_year": np.full(k.shape[0], year), key[0]: k[o], "ext_price": s[o]}
    if q == "q7":  # gender 1, marital 2, education 3, year 2000
        cd, pr = h["customer_demographics"], h["promotion"]
        cd_ok = (cd["cd_gender"] == 1) & (cd["cd_marital_status"] == 2) & (
            cd["cd_education_status"] == 3)
        pr_ok = (pr["p_channel_email"] == 0) | (pr["p_channel_event"] == 0)
        ss = h["store_sales"]
        keep = ((dd["d_year"][ss["ss_sold_date_sk"]] == 2000) & cd_ok[ss["ss_cdemo_sk"]]
                & pr_ok[ss["ss_promo_sk"]])
        item_id = it["i_item_id"][ss["ss_item_sk"][keep]]
        want = {}
        for out, src in (("agg2", "ss_list_price"), ("agg3", "ss_coupon_amt"),
                         ("agg4", "ss_sales_price")):
            (ids,), nums, e0, cnt = _exact_groups(ss[src][keep], [item_id])
            want[out] = _rounded(nums, e0, cnt)
        from fractions import Fraction

        inv = np.searchsorted(ids, item_id)
        qty = np.zeros(ids.shape[0], np.int64)
        np.add.at(qty, inv, ss["ss_quantity"][keep])
        agg1 = np.array([float(Fraction(int(a), int(c))) for a, c in zip(qty, cnt)])
        return {"i_item_id": ids, "agg1": agg1, **want}
    if q == "q19":  # manager 8, month 11, year 1998
        cu, ca, st = h["customer"], h["customer_address"], h["store"]

        def when(ss):
            d = ss["ss_sold_date_sk"]
            zip_c = ca["ca_zip5"][cu["c_current_addr_sk"][ss["ss_customer_sk"]]]
            return ((dd["d_moy"][d] == 11) & (dd["d_year"][d] == 1998)
                    & (it["i_manager_id"][ss["ss_item_sk"]] == 8)
                    & (zip_c != st["s_zip5"][ss["ss_store_sk"]]))

        (b, m), nums, e0, _ = _star_sales(
            h, when, lambda ss, k: [it["i_brand_id"][ss["ss_item_sk"][k]],
                                    it["i_manufact_id"][ss["ss_item_sk"][k]]])
        s = _rounded(nums, e0)
        o = np.lexsort((m, b, -s))
        return {"i_brand_id": b[o], "i_manufact_id": m[o], "ext_price": s[o]}
    raise ValueError(q)


def _check_tpcds(stars, out):
    """Every query's result against its numpy oracle: group keys, order and
    counts exact, every float bit for bit. Returns the result sizes."""
    hosts = {}
    sizes = {}
    for q, star in TPCDS_QUERIES:
        if star not in hosts:
            hosts[star] = _host_star(stars[star])
        want = _tpcds_oracle(q, hosts[star])
        got = out[q]
        if q in ("q94", "q95"):
            for k, w in want.items():
                if np.float64(got[k]).view(np.uint64) != np.float64(w).view(np.uint64):
                    raise AssertionError(f"{q} {k}: {got[k]!r}, oracle {w!r}")
            if not want["order_count"]:
                raise AssertionError(f"{q} selected no order")
            sizes[q] = want["order_count"]
            continue
        if got.names != list(want):
            raise AssertionError(f"{q} columns {got.names}, oracle {list(want)}")
        if got.num_rows == 0:
            raise AssertionError(f"{q} selected no row")
        for name, w in want.items():
            c = got.column(name)
            if c.validity is not None and not bool(c.validity.all()):
                raise AssertionError(f"{q} {name} has nulls")
            g = c.to_numpy()
            if c.dtype.id.name == "FLOAT64":
                ok = np.array_equal(g.view(np.uint64), np.asarray(w, np.float64).view(np.uint64))
            else:
                ok = np.array_equal(g.astype(np.int64), np.asarray(w, np.int64))
            if not ok:
                raise AssertionError(f"{q} {name} differs from the numpy oracle")
        sizes[q] = got.num_rows
    return sizes


# ---------------------------------------------------------------------------
# the spark_exact path: the reference's own Spark-exact operators
# ---------------------------------------------------------------------------


def _precision10(v: int) -> int:
    """The reference's precision10 (decimal_utils.cu:505-521): the smallest
    i with 10^i >= v, so an exact power of ten counts one less than its
    digits."""
    if v <= 1:
        return 0
    d = len(str(v))
    return d - 1 if v == 10 ** (d - 1) else d


def _div_round(n: int, d: int) -> int:
    """n / d rounded half up (round_from_remainder: up when 2r >= d)."""
    q, r = divmod(n, d)
    return q + (2 * r >= d)


def _fits128(mag: int, negative: bool) -> bool:
    return mag <= (2**127 if negative else 2**127 - 1)


def _dec_mul_oracle(a: int, b: int, sa: int, sb: int, ps: int):
    """(overflow, unscaled product or None) of dec128_multiplier
    (decimal_utils.cu:524-592) in Python ints: the exact product, the
    SPARK-40129 first rounding to precision 38 by precision10, then the
    rescale to ``ps`` (multiply up, overflowing past precision 38, or
    divide and round half up); overflow past a signed 128-bit value."""
    negative = (a < 0) != (b < 0)
    p = abs(a) * abs(b)
    scale = sa + sb
    first = _precision10(p) - 38
    if first > 0:
        p = _div_round(p, 10**first)
        scale += first
    exponent = ps - scale
    if exponent < 0:
        if _precision10(p) - exponent > 38:
            return True, None
        p *= 10**-exponent
    else:
        p = _div_round(p, 10**min(exponent, 76))
    if not _fits128(p, negative):
        return True, None
    return False, -p if negative else p


def _dec_div_oracle(a: int, b: int, sa: int, sb: int, qs: int):
    """(overflow, unscaled quotient or None) of dec128_divider
    (decimal_utils.cu:595-684) in Python ints: a zero divisor gives
    overflow and 0; by n_shift_exp = qs - (sa - sb), divide then divide
    and round (> 0), base-10 long division through a 10^38 split with
    256-bit wrapping products (< -38), or multiply then divide and round;
    rounding half up from the remainder."""
    if b == 0:
        return True, 0
    negative = (a < 0) != (b < 0)
    n, d = abs(a), abs(b)
    shift = qs - (sa - sb)
    wrap = 2**256
    if shift > 0:
        q = _div_round(n // d, 10**min(shift, 76))
    elif shift < -38:
        mult = 10**min(-shift - 38, 76)
        q1, r1 = divmod(n * 10**38, d)
        q2, r2 = divmod(r1 * mult % wrap, d)
        q = (q1 * mult + q2 + (2 * r2 >= d)) % wrap
    else:
        q = _div_round(n * 10**-shift, d)
    if not _fits128(q, negative):
        return True, None
    return False, -q if negative else q


def _zorder_oracle(limbs, nbits: int) -> np.ndarray:
    """Delta's interleaveBits (ZOrderTest.java:31-67) in numpy: for each
    value bit from the most significant down, one bit of every column in
    turn, packed most significant bit first. ``limbs`` holds each
    column's [N, L] uint32 little-endian limbs (nulls as 0); returns the
    [N, C * nbits / 8] uint8 rows."""
    j = np.arange(nbits - 1, -1, -1)
    bits = np.stack([(c[:, j // 32] >> (j % 32).astype(np.uint32)) & 1 for c in limbs], axis=2)
    return np.packbits(bits.astype(np.uint8).reshape(bits.shape[0], -1), axis=1, bitorder="big")


SPARK_ROWS = ROWS  # a Spark batch, the other paths' rows
# string -> integer: (string, value) of each target's limits and one past them
INT_LIMITS = (("9223372036854775807", 2**63 - 1), ("9223372036854775808", 2**63),
              ("-9223372036854775808", -(2**63)), ("-9223372036854775809", -(2**63) - 1),
              ("2147483647", 2**31 - 1), ("2147483648", 2**31), ("-2147483648", -(2**31)),
              ("-2147483649", -(2**31) - 1), ("18446744073709551615", 2**64 - 1),
              ("18446744073709551616", 2**64), ("0", 0))
INT_INVALID = ("", "abc", "12a", "-", "+", "1 2", "--5", "0x10", "1,000", "1e5", " ", "+-3")
INT_TARGETS = (("INT64", -(2**63), 2**63 - 1), ("INT32", -(2**31), 2**31 - 1),
               ("UINT64", 0, 2**64 - 1))
# string -> decimal: (precision, cudf scale) for DECIMAL128, DECIMAL64, DECIMAL32
DEC_TARGETS = ((38, -10), (18, -4), (9, -2))
DEC_INVALID = ("abc", "12a", "1.2.3", "--1", "1 2", "", "1e2 ", "-1.5E3\t")
SPARK_SCALE = -10  # DECIMAL(38, 10) operands
PRODUCT_SCALE = -6  # Spark's DECIMAL(38, 6) result under allowPrecisionLoss
ZORDER_RANGES = 1000  # Delta's default range ids per column (rangeId.max)
ANSI_BAD_ROW = 765_432


def _strings_parts(strs):
    """(offsets int32, chars uint8) of a list of str."""
    enc = [x.encode() for x in strs]
    offs = np.zeros(len(enc) + 1, np.int64)
    np.cumsum([len(e) for e in enc], out=offs[1:])
    return offs.astype(np.int32), np.frombuffer(b"".join(enc), np.uint8)


def _int_strings(rng, n: int):
    """The string -> integer input: integers uniform in [-10^8, 10^8) (the
    reference-shaped microbench's), and at seeded rows leading and
    trailing whitespace, a '+' sign, a non-ANSI truncation ('12.7' -> 12),
    each target's limit and limit + 1, invalid strings, and nulls. Returns
    (strings, valid, value: Python int or None where invalid, signed: the
    string carries a sign)."""
    vals = rng.integers(-(10**8), 10**8, n).tolist()
    strs = [str(v) for v in vals]
    value = list(vals)
    signed = [v < 0 for v in vals]
    cls = rng.integers(0, 100, n)
    for i in np.flatnonzero(cls < 6).tolist():
        c = int(cls[i])
        if c == 0:  # leading and trailing whitespace
            strs[i] = "".join(rng.choice([" ", "\t", "\r", "\n"], 2)) + strs[i] + "  "
        elif c == 1:  # a '+' sign
            value[i] = abs(value[i])
            strs[i], signed[i] = "+" + str(value[i]), True
        elif c == 2:  # non-ANSI truncation at the '.'
            strs[i] += "." + str(int(rng.integers(0, 1000)))
        elif c in (3, 4):  # the targets' limits and one past them
            strs[i], value[i] = INT_LIMITS[int(rng.integers(0, len(INT_LIMITS)))]
            signed[i] = strs[i].startswith("-")
        else:
            strs[i], value[i] = INT_INVALID[int(rng.integers(0, len(INT_INVALID)))], None
    return strs, rng.random(n) >= 0.02, value, signed


def _int_oracle(valid, value, signed, lo: int, hi: int):
    """(expected values as Python ints with 0 for null, validity) of one
    integer target: null where the input is null or invalid, out of the
    target's range, or signed for an unsigned target."""
    unsigned = lo == 0
    ok = [bool(a) and v is not None and lo <= v <= hi and not (unsigned and s)
          for a, v, s in zip(valid.tolist(), value, signed)]
    return [v if k else 0 for v, k in zip(value, ok)], np.array(ok)


def _dec_strings(rng, n: int):
    """The string -> decimal input: values of a seeded 1-38 digit count
    with the decimal point anywhere, some in exponent notation, a sign on
    45%, leading or trailing whitespace on some, invalid strings and
    nulls. Returns (strings, valid, (mantissa, exponent, location): the
    value as int * 10^exponent and its decimal location -- the digits
    before the point moved by the exponent -- or None where invalid)."""
    k = rng.integers(1, 39, n)
    digits = rng.integers(48, 58, (n, 38), dtype=np.uint8)
    digits[:, 0] = rng.integers(49, 58, n, dtype=np.uint8)
    point = (rng.random(n) * (k + 1)).astype(np.int64)
    expo = np.where(rng.random(n) < 0.2, rng.integers(-20, 21, n), 0)
    sign = rng.random(n)
    ws = rng.random(n)
    bad = rng.random(n) < 0.005
    strs, parsed = [], []
    for i in range(n):
        if bad[i]:
            strs.append(DEC_INVALID[i % len(DEC_INVALID)])
            parsed.append(None)
            continue
        d = digits[i, :k[i]].tobytes().decode()
        p, e = int(point[i]), int(expo[i])
        body = (d[:p] or "0") + "." + d[p:] if p < k[i] else d
        if e:
            body += ("E" if i % 2 else "e") + str(e)
        m = int(d)
        if sign[i] < 0.4:
            body, m = "-" + body, -m
        elif sign[i] < 0.45:
            body = "+" + body
        if ws[i] < 0.05:
            body = " \t" + body
        elif ws[i] < 0.1 and not e:  # whitespace after exponent digits is invalid
            body += " \n"
        strs.append(body)
        parsed.append((m, e - (int(k[i]) - p), (max(p, 1) if p < k[i] else int(k[i])) + e))
    return strs, rng.random(n) >= 0.02, parsed


def _dec_oracle(valid, parsed, precision: int, scale: int):
    """(expected unscaled Python ints with 0 for null, validity, fault) of
    one decimal target by Spark's cast: the value rounded half up away
    from zero to 10^scale, null where null, invalid or past the
    precision. ``fault`` marks the rows of the reference's known fault
    (ROADMAP section 3), whose value the reference gets wrong: the
    exponent puts the decimal location below 0 and the rounding carries
    into a new digit (the kept digits all nines), where the reference
    counts that digit before the decimal point and pads one zero too many
    (ten times Spark's value)."""
    out, ok, fault = [], [], []
    bound = 10**precision
    for a, pv in zip(valid.tolist(), parsed):
        if not a or pv is None:
            out.append(0)
            ok.append(False)
            fault.append(False)
            continue
        m, e, location = pv
        shift = e - scale
        carried = False
        if shift >= 0:
            mag = abs(m) * 10**shift
        else:
            q, r = divmod(abs(m), 10**-shift)
            mag = q + (2 * r >= 10**-shift)
            carried = mag > q and q and str(q).count("9") == len(str(q))
        good = mag < bound
        out.append((-mag if m < 0 else mag) if good else 0)
        ok.append(good)
        fault.append(bool(good and carried and location < 0))
    return out, np.array(ok), np.array(fault)


def _limbs_of(values) -> np.ndarray:
    """Python ints (signed, 128-bit) -> [N, 4] uint32 two's complement limbs."""
    blob = b"".join(int(v).to_bytes(16, "little", signed=True) for v in values)
    return np.frombuffer(blob, np.uint32).reshape(-1, 4)


def _dec_operands(rng, n: int):
    """DECIMAL(38, 10) operands: a seeded 1-38 digit count and sign each,
    about 1% zero divisors, and nulls on about 5% of the rows (2.5% in
    each operand)."""
    out = []
    for _ in range(2):
        k = rng.integers(1, 39, n)
        digits = rng.integers(48, 58, (n, 38), dtype=np.uint8)
        neg = rng.random(n) < 0.5
        out.append([(-1 if neg[i] else 1) * int(digits[i, :k[i]].tobytes()) for i in range(n)])
    a, b = out
    for i in np.flatnonzero(rng.random(n) < 0.01).tolist():
        b[i] = 0
    return a, b, rng.random(n) >= 0.025, rng.random(n) >= 0.025


def _spark_exact_inputs(seed: int, n: int = SPARK_ROWS, device=None):
    """Host data made from ``seed`` with numpy and uploaded through
    ``carry_table``: the string columns of both casts, the DECIMAL(38, 10)
    operands, Z-order's INT32 range ids (nulls in one column) and INT64
    columns, and UINT32 / UINT64 columns with nulls."""
    from spark_rapids_jni_tpu_torch.columnar import Table
    from spark_rapids_jni_tpu_torch.columnar import dtype as pdt
    from spark_rapids_jni_tpu_torch.interop import carry_table

    rng = np.random.default_rng(seed)
    h = {"n": n}
    h["int"] = _int_strings(rng, n)
    strs, valid, value, _ = h["int"]
    ansi = [str(v) if v is not None and -(2**63) <= v < 2**63 else "0" for v in value]
    ansi[ANSI_BAD_ROW % n] = "12x4"
    ansi_valid = valid.copy()
    ansi_valid[ANSI_BAD_ROW % n] = True  # an incoming null never raises
    h["ansi"] = ansi
    h["dec"] = _dec_strings(rng, n)
    h["ops"] = _dec_operands(rng, n)
    h["z32"] = [rng.integers(0, ZORDER_RANGES, n).astype(np.int32) for _ in range(3)]
    h["z32_valid"] = rng.random(n) >= 0.05
    h["z64"] = [rng.integers(-(2**63), 2**63 - 1, n, endpoint=True) for _ in range(4)]
    h["u32"] = rng.integers(0, 2**32, n, dtype=np.uint32)
    h["u64"] = rng.integers(0, 2**64, n, dtype=np.uint64, endpoint=False)
    h["u_valid"] = rng.random(n) >= 0.03

    a, b, va, vb = h["ops"]
    cols = [(_strings_parts(strs), pdt.STRING, valid), (_strings_parts(ansi), pdt.STRING, ansi_valid),
            (_strings_parts(h["dec"][0]), pdt.STRING, h["dec"][1]),
            (_limbs_of(a), pdt.decimal128(SPARK_SCALE), va),
            (_limbs_of(b), pdt.decimal128(SPARK_SCALE), vb),
            *((z, pdt.INT32, h["z32_valid"] if i == 1 else None) for i, z in enumerate(h["z32"])),
            *((z, pdt.INT64, None) for z in h["z64"]),
            (h["u32"], pdt.UINT32, h["u_valid"]), (h["u64"], pdt.UINT64, h["u_valid"])]
    names = ["ints", "ansi", "decs", "a", "b", "z0", "z1", "z2", "w0", "w1", "w2", "w3",
             "u32", "u64"]
    t = carry_table([c[0] for c in cols], [c[1] for c in cols], [c[2] for c in cols],
                    device=device)
    return h, Table(t.columns, names)


def _spark_exact_ops(t):
    """name -> a call of the port's entry point on the uploaded table."""
    from spark_rapids_jni_tpu_torch.columnar import dtype as pdt
    from spark_rapids_jni_tpu_torch.ops import cast_string, decimal_utils, zorder
    from spark_rapids_jni_tpu_torch.ops import expressions as ex

    ops = {}
    for tn, _, _ in INT_TARGETS:
        ops[f"to_{tn.lower()}"] = (lambda d: lambda: cast_string.string_to_integer(
            t.column("ints"), False, d))(getattr(pdt, tn))
    for p, sc in DEC_TARGETS:
        ops[f"to_decimal_{p}_{-sc}"] = (lambda p, sc: lambda: cast_string.string_to_decimal(
            t.column("decs"), False, p, sc))(p, sc)
    ops["multiply128"] = lambda: decimal_utils.multiply128(t.column("a"), t.column("b"),
                                                           PRODUCT_SCALE)
    ops["divide128"] = lambda: decimal_utils.divide128(t.column("a"), t.column("b"), PRODUCT_SCALE)
    ops["zorder_int32x3"] = lambda: zorder.interleave_bits(
        t.num_rows, *(t.column(f"z{i}") for i in range(3)))
    ops["zorder_int64x4"] = lambda: zorder.interleave_bits(
        t.num_rows, *(t.column(f"w{i}") for i in range(4)))
    ops["u32_filter"] = lambda: ((ex.col("u32") + 7) % 1000 > 3).evaluate(t)
    ops["u64_filter"] = lambda: ((ex.col("u64") + 7) % 1000 > 3).evaluate(t)
    ops["u64_cast_u32"] = lambda: ex.col("u64").cast(pdt.UINT32).evaluate(t)
    return ops


def _spark_exact_path(ops):
    """Every operation once; host ms of each, each ending in a synchronize."""
    import torch

    out, stage = {}, {}
    for name, op in ops.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = op()
        torch.cuda.synchronize()
        stage[f"{name}_ms"] = (time.perf_counter() - t0) * 1e3
    stage["end_to_end_ms"] = sum(stage.values())
    return out, stage


def _expect(col, want, ok, what: str, where=None):
    """A column's validity exactly ``ok``, and its values (one word or [N, 4]
    limbs a row) exactly ``want`` on the rows of ``where`` (default ``ok``)."""
    got_ok = col.valid_mask().cpu().numpy()
    if not np.array_equal(got_ok, ok):
        bad = np.flatnonzero(got_ok != ok)
        raise AssertionError(f"{what}: validity differs on {bad.size} rows, first {bad[:5]}")
    where = ok if where is None else where
    got = col.to_numpy()
    want = np.asarray(want, dtype=got.dtype) if got.ndim == 1 else want
    if not np.array_equal(got[where], want[where]):
        bad = np.flatnonzero(where & np.any((got != want).reshape(len(where), -1), axis=1))
        raise AssertionError(f"{what}: values differ on {bad.size} rows, first {bad[:5]}")


def _check_spark_exact(h, t, out) -> dict:
    """Every result against its independent oracle; the ANSI run must raise
    CastError with the bad row and its string. Returns counts."""
    import torch
    from spark_rapids_jni_tpu_torch.columnar import dtype as pdt
    from spark_rapids_jni_tpu_torch.ops import cast_string

    n = h["n"]
    summary = {}
    _, valid, value, signed = h["int"]
    for tn, lo, hi in INT_TARGETS:
        want, ok = _int_oracle(valid, value, signed, lo, hi)
        if tn == "UINT64":
            want = [v % 2**64 for v in want]
        _expect(out[f"to_{tn.lower()}"], np.array(want, dtype=np.int64 if tn != "UINT64"
                                                  else np.uint64), ok, f"string -> {tn}")
        summary[f"to_{tn.lower()}_valid"] = int(ok.sum())
    try:
        cast_string.string_to_integer(t.column("ansi"), True, pdt.INT64)
    except cast_string.CastError as e:
        if (e.row_with_error, e.string_with_error) != (ANSI_BAD_ROW % n, "12x4"):
            raise AssertionError(f"ANSI cast raised for row {e.row_with_error} "
                                 f"{e.string_with_error!r}, not {ANSI_BAD_ROW % n} '12x4'")
    else:
        raise AssertionError("the ANSI cast did not raise on its bad row")
    summary["ansi_row"] = ANSI_BAD_ROW % n

    _, dvalid, parsed = h["dec"]
    for p, sc in DEC_TARGETS:
        want, ok, fault = _dec_oracle(dvalid, parsed, p, sc)
        col = out[f"to_decimal_{p}_{-sc}"]
        if col.dtype.scale != sc:
            raise AssertionError(f"string -> DECIMAL({p}, {-sc}) has scale {col.dtype.scale}")
        # validity on every row; values on the valid rows outside the
        # reference's known fault, whose rows are counted
        _expect(col, _limbs_of(want) if p > 18 else np.array(want), ok,
                f"string -> DECIMAL({p}, {-sc})", where=ok & ~fault)
        summary[f"to_decimal_{p}_{-sc}_valid"] = int(ok.sum())
        summary[f"to_decimal_{p}_{-sc}_fault_rows"] = int(fault.sum())
        print(f"string -> DECIMAL({p}, {-sc}): {int(fault.sum())} valid rows in the reference's "
              f"known fault class (a carry below the decimal point) left out of the value "
              f"comparison", flush=True)

    a, b, va, vb = h["ops"]
    both = va & vb
    for name, oracle in (("multiply128", _dec_mul_oracle), ("divide128", _dec_div_oracle)):
        res = [oracle(x, y, SPARK_SCALE, SPARK_SCALE, PRODUCT_SCALE) for x, y in zip(a, b)]
        ovf = np.array([r[0] for r in res])
        got = out[name]
        _expect(got.columns[0], ovf.astype(np.uint8), both, f"{name} overflow")
        keep = both & (~ovf | np.array([y == 0 for y in b]))  # a zero divisor writes 0
        _expect(got.columns[1], _limbs_of([0 if r[1] is None else r[1] for r in res]), both,
                f"{name} value", where=keep)
        summary[f"{name}_overflow"] = int((ovf & both).sum())
    summary["zero_divisors"] = int(sum(y == 0 for y in b))
    # rows whose product took the SPARK-40129 first rounding to precision 38
    summary["multiply128_first_rounding"] = int(sum(
        _precision10(abs(x * y)) > 38 for x, y in zip(a, b)))

    for name, cols, valids, nbits in (
            ("zorder_int32x3", h["z32"], [None, h["z32_valid"], None], 32),
            ("zorder_int64x4", h["z64"], [None] * 4, 64)):
        limbs = [np.where(v[:, None], c.view(np.uint32).reshape(n, -1), 0) if v is not None
                 else c.view(np.uint32).reshape(n, -1) for c, v in zip(cols, valids)]
        want = _zorder_oracle(limbs, nbits)
        got = out[name]
        row = want.shape[1]
        if not (np.array_equal(got.offsets.cpu().numpy(), np.arange(n + 1, dtype=np.int64) * row)
                and np.array_equal(got.child.data.cpu().numpy().reshape(n, row), want)):
            raise AssertionError(f"{name} differs from Delta's interleaveBits")

    uv = h["u_valid"]
    with np.errstate(over="ignore"):
        for name, u in (("u32_filter", h["u32"]), ("u64_filter", h["u64"])):
            _expect(out[name], ((u + u.dtype.type(7)) % u.dtype.type(1000) > 3).astype(np.uint8),
                    uv, name)
    _expect(out["u64_cast_u32"], h["u64"].astype(np.uint32), uv, "u64_cast_u32")
    torch.cuda.synchronize()
    return summary


# ---------------------------------------------------------------------------
# the string_ops path: the string and regex tier on one Spark batch
# ---------------------------------------------------------------------------
SOPS_ROWS = ROWS  # a Spark batch, the other paths' rows
SOPS_NULLS = 0.05
SOPS_EMPTY = 0.01
SOPS_TLDS = (b"com", b"org", b"net", b"edu", b"io")
EMAIL_RE = r"[\w.]+@\w+\.(?:com|org|net|edu)"  # an alternation of TLDs, ".io" left out
EMAIL_GROUPS = r"([\w.]+)@(\w+)"  # three top-level members: one all-starts run each
URL_DIGITS = r"\d{2,}"
INSTR_NEEDLE = "é"  # a 2-byte needle
SUBSTRINGS = (("email", 3, 5), ("url", 0, 12), ("email", -6, 4), ("multi", 2, 3))
SPLIT_LIMITS = (-1, 3, 0)
_ALNUM = b"abcdefghijklmnopqrstuvwxyz0123456789"
# the multilingual column's codepoints: (first, last, weight)
_MULTI_RANGES = ((0x61, 0x7A, 0.2), (0x41, 0x5A, 0.1), (0xC0, 0xFF, 0.2), (0x391, 0x3A9, 0.07),
                 (0x3B1, 0x3C9, 0.08), (0x4E00, 0x4E7F, 0.15), (0x1F600, 0x1F64F, 0.06),
                 (0x20, 0x20, 0.08))
_MULTI_SPECIAL = (0x23A, 0x2C65, 0xDF, 0x390)  # a length-changing pair, and two that expand


def _draw_rows(rng, alphabet: bytes, lens) -> list:
    """Random rows of ``alphabet`` of the given lengths, in one draw."""
    lens = np.asarray(lens, np.int64)
    buf = np.frombuffer(alphabet, np.uint8)[rng.integers(0, len(alphabet), int(lens.sum()))].tobytes()
    ends = np.cumsum(lens).tolist()
    starts = [0] + ends[:-1]
    return [buf[a:b] for a, b in zip(starts, ends)]


def _sops_emails(rng, n: int) -> list:
    local = _draw_rows(rng, _ALNUM + b"._", rng.integers(3, 21, n))
    dom = _draw_rows(rng, _ALNUM[:26], rng.integers(3, 13, n))
    tld = rng.integers(0, len(SOPS_TLDS), n).tolist()
    at = np.where(rng.random(n) < 0.02, ord("."), ord("@")).tolist()  # ~2% without '@'
    return [lo + bytes((a,)) + d + b"." + SOPS_TLDS[t] for lo, a, d, t in zip(local, at, dom, tld)]


def _sops_urls(rng, n: int) -> list:
    host = _draw_rows(rng, _ALNUM[:26], rng.integers(3, 13, n))
    tld = rng.integers(0, len(SOPS_TLDS), n).tolist()
    nseg = rng.integers(0, 4, n)
    segs = _draw_rows(rng, _ALNUM, rng.integers(1, 11, int(nseg.sum())))
    q = rng.random(n) < 0.5
    qd = _draw_rows(rng, b"0123456789", np.where(q, rng.integers(1, 7, n), 0))
    https = (rng.random(n) < 0.5).tolist()
    out, k = [], 0
    for i in range(n):
        u = (b"https://www." if https[i] else b"http://www.") + host[i] + b"." + SOPS_TLDS[tld[i]]
        for _ in range(int(nseg[i])):
            u += b"/" + segs[k]
            k += 1
        if qd[i]:
            u += b"?id=" + qd[i] + b"&p=" + qd[i][:2]
        if len(u) < 20:
            u += b"/index.html"
        out.append(u[:80])
    return out


def _sops_multi(rng, n: int) -> list:
    """1-24 codepoints a row: ASCII, Latin-1 accents, Greek, CJK, emoji,
    U+023A / U+2C65 (2 and 3 bytes: their case map changes the length),
    ß and ΐ, and leading / trailing spaces."""
    lens = rng.integers(1, 25, n)
    total = int(lens.sum())
    w = np.array([r[2] for r in _MULTI_RANGES])
    which = rng.choice(len(_MULTI_RANGES), total, p=w / w.sum())
    lo = np.array([r[0] for r in _MULTI_RANGES])[which]
    hi = np.array([r[1] for r in _MULTI_RANGES])[which]
    cps = lo + (rng.random(total) * (hi - lo + 1)).astype(np.int64)
    special = rng.random(total) < 0.03
    cps[special] = np.array(_MULTI_SPECIAL)[rng.integers(0, len(_MULTI_SPECIAL), int(special.sum()))]
    ends = np.cumsum(lens)
    starts = ends - lens
    lead = rng.random(n) < 0.2
    cps[starts[lead]] = 0x20
    trail = rng.random(n) < 0.2
    cps[ends[trail] - 1] = 0x20
    text = cps.astype("<u4").tobytes().decode("utf-32-le")
    return [text[a:b].encode() for a, b in zip(starts.tolist(), ends.tolist())]


def _sops_lists(rng, n: int) -> list:
    nf = rng.integers(0, 9, n)
    fields = _draw_rows(rng, _ALNUM, rng.integers(0, 7, int(nf.sum())))
    out, k = [], 0
    for f in nf.tolist():
        out.append(b",".join(fields[k:k + f]))
        k += f
    return out


def _bytes_parts(rows):
    """(offsets int32, chars uint8) of a list of bytes."""
    offs = np.zeros(len(rows) + 1, np.int64)
    np.cumsum([len(r) for r in rows], out=offs[1:])
    return offs.astype(np.int32), np.frombuffer(b"".join(rows), np.uint8)


def _string_ops_inputs(seed: int, n: int = SOPS_ROWS, device=None):
    """Four STRING columns made from ``seed`` with numpy and uploaded
    through ``carry_table``: emails, URLs, multilingual text and comma
    lists, each with 5% nulls (empty bytes under the null) and 1% empty
    strings. Returns (host rows and validity by name, the Table)."""
    from spark_rapids_jni_tpu_torch.columnar import Table
    from spark_rapids_jni_tpu_torch.columnar import dtype as pdt
    from spark_rapids_jni_tpu_torch.interop import carry_table

    rng = np.random.default_rng(seed)
    names = ("email", "url", "multi", "list")
    h = {"n": n}
    for name, make in zip(names, (_sops_emails, _sops_urls, _sops_multi, _sops_lists)):
        rows = make(rng, n)
        valid = rng.random(n) >= SOPS_NULLS
        for i in np.flatnonzero(~valid | (rng.random(n) < SOPS_EMPTY)).tolist():
            rows[i] = b""
        h[name] = (rows, valid)
    t = carry_table([_bytes_parts(h[k][0]) for k in names], [pdt.STRING] * 4,
                    [h[k][1] for k in names], device=device)
    return h, Table(t.columns, list(names))


def _utf8_roundtrip(col):
    """decode_padded then encode_padded of a column's padded bytes."""
    from spark_rapids_jni_tpu_torch.ops import strings, utf8

    padded, lens = strings.to_padded(col)
    cp, cp_lens, _ = utf8.decode_padded(padded, lens)
    out, out_lens = utf8.encode_padded(cp, cp_lens)
    return padded, lens, out, out_lens, cp_lens


def _string_ops(t):
    """name -> a call of the port's entry point on the uploaded table."""
    from spark_rapids_jni_tpu_torch.ops import regex, strings

    e, u, m, lst = (t.column(k) for k in ("email", "url", "multi", "list"))
    col = {"email": e, "url": u, "multi": m}
    ops = {"length_email": lambda: strings.length(e), "length_multi": lambda: strings.length(m),
           "upper_email": lambda: strings.upper(e), "lower_url": lambda: strings.lower(u),
           "upper_multi": lambda: strings.upper(m), "lower_multi": lambda: strings.lower(m)}
    for c, s, k in SUBSTRINGS:
        ops[f"substring_{c}_{s}_{k}"] = (lambda c, s, k: lambda: strings.substring(col[c], s, k))(
            c, s, k)
    ops.update({
        "concat": lambda: strings.concat([e, lst], b"|"),
        "concat_ws": lambda: strings.concat_ws([e, m, lst], b"-"),
        "contains_at": lambda: strings.contains(e, b"@"),
        "startswith_https": lambda: strings.startswith(u, b"https"),
        "endswith_com": lambda: strings.endswith(e, b".com"),
        "strip_multi": lambda: strings.strip(m),
        "instr_multi": lambda: strings.instr(m, INSTR_NEEDLE.encode()),
        "utf8_roundtrip": lambda: _utf8_roundtrip(m),
        "contains_re_digits": lambda: regex.contains_re(u, URL_DIGITS),
        "matches_re_email": lambda: regex.matches_re(e, EMAIL_RE),
    })
    for g in (0, 1, 2):
        ops[f"extract_re_{g}"] = (lambda g: lambda: regex.extract_re(e, EMAIL_GROUPS, g))(g)
    for lim in SPLIT_LIMITS:
        ops[f"split_re_{lim}"] = (lambda lim: lambda: regex.split_re(lst, ",", lim))(lim)
    ops["replace_re_digits"] = lambda: regex.replace_re(u, r"\d+", b"#")
    return ops


def _sub_seq(s, start: int, slen):
    """SUBSTRING's window over a sequence (bytes for the reference, str
    for Spark): 1-based start, 0 as 1, a negative start from the end
    spending its length budget off the string."""
    b0 = start - 1 if start > 0 else (0 if start == 0 else len(s) + start)
    e0 = len(s) if slen is None else b0 + max(slen, 0)
    b, e = min(max(b0, 0), len(s)), min(max(e0, 0), len(s))
    return s[b:e] if e > b else s[:0]


_CASE_1TO1: dict = {}


def _case_1to1(s: str, upper: bool) -> str:
    """The reference's case map: Python's mapping where it is one BMP
    character to one, the character itself elsewhere."""
    out = []
    for c in s:
        key = (c, upper)
        m = _CASE_1TO1.get(key)
        if m is None:
            m = c.upper() if upper else c.lower()
            m = m if ord(c) < 0x10000 and len(m) == 1 and ord(m) < 0x10000 else c
            _CASE_1TO1[key] = m
        out.append(m)
    return "".join(out)


def _java_split(s: str, sep: str, limit: int) -> list:
    """Java String.split for a separator that cannot match the empty
    string (Spark's split)."""
    toks = s.split(sep) if limit <= 0 else s.split(sep, limit - 1)
    if limit == 0 and s:
        while toks and toks[-1] == "":
            toks.pop()
    return toks


def _host_rows(col):
    """A port STRING column's rows as bytes, and its validity."""
    offs = col.offsets.cpu().numpy().tolist()
    chars = col.chars.cpu().numpy().tobytes()
    return [chars[a:b] for a, b in zip(offs[:-1], offs[1:])], col.valid_mask().cpu().numpy()


def _expect_rows(col, want, ok, what: str):
    """A STRING column's validity exactly ``ok`` and its bytes ``want`` on
    those rows."""
    rows, got_ok = _host_rows(col)
    if not np.array_equal(got_ok, ok):
        bad = np.flatnonzero(got_ok != ok)
        raise AssertionError(f"{what}: validity differs on {bad.size} rows, first {bad[:5]}")
    bad = [i for i in np.flatnonzero(ok).tolist() if rows[i] != want[i]]
    if bad:
        raise AssertionError(f"{what}: {len(bad)} rows differ, first {bad[:3]}: "
                             f"{[(rows[i], want[i]) for i in bad[:3]]}")


def _check_string_ops(h, out) -> dict:
    """Every result against an independent per-row oracle on the host
    (``str`` / ``bytes`` methods and ``re`` under re.ASCII, the
    reference's ASCII \\d \\w \\s). Where the reference's semantics are
    not Spark's (byte-counted length and substring, the 1:1 case map),
    the rows whose Spark result differs are counted."""
    import re

    import torch

    summary = {}
    rows = {k: h[k][0] for k in ("email", "url", "multi", "list")}
    ok = {k: h[k][1] for k in rows}
    text = {k: [r.decode() for r in v] for k, v in rows.items()}

    for c in ("email", "multi"):
        _expect(out[f"length_{c}"], np.array([len(r) for r in rows[c]], np.int32), ok[c],
                f"length({c})")
    summary["length_multi_spark_differs"] = int(sum(
        len(r) != len(s) for r, s, v in zip(rows["multi"], text["multi"], ok["multi"]) if v))
    _expect_rows(out["upper_email"], [r.upper() for r in rows["email"]], ok["email"], "upper(email)")
    _expect_rows(out["lower_url"], [r.lower() for r in rows["url"]], ok["url"], "lower(url)")
    for fn in ("upper", "lower"):
        _expect_rows(out[f"{fn}_multi"], [_case_1to1(s, fn == "upper").encode()
                                          for s in text["multi"]], ok["multi"], f"{fn}(multi)")
        summary[f"{fn}_multi_spark_differs"] = int(sum(
            _case_1to1(s, fn == "upper") != getattr(s, fn)()
            for s, v in zip(text["multi"], ok["multi"]) if v))
    for c, s, k in SUBSTRINGS:
        _expect_rows(out[f"substring_{c}_{s}_{k}"], [_sub_seq(r, s, k) for r in rows[c]], ok[c],
                     f"substring({c}, {s}, {k})")
    summary["substring_multi_spark_differs"] = int(sum(
        _sub_seq(r, 2, 3) != _sub_seq(s, 2, 3).encode()
        for r, s, v in zip(rows["multi"], text["multi"], ok["multi"]) if v))

    _expect_rows(out["concat"], [a + b"|" + b for a, b in zip(rows["email"], rows["list"])],
                 ok["email"] & ok["list"], "concat(email, list)")
    ws = [b"-".join(p for p, v in zip(parts, vs) if v) for parts, vs in zip(
        zip(rows["email"], rows["multi"], rows["list"]),
        zip(ok["email"], ok["multi"], ok["list"]))]
    _expect_rows(out["concat_ws"], ws, np.ones(h["n"], bool), "concat_ws(email, multi, list)")
    for name, c, fn in (("contains_at", "email", lambda r: b"@" in r),
                        ("startswith_https", "url", lambda r: r.startswith(b"https")),
                        ("endswith_com", "email", lambda r: r.endswith(b".com"))):
        _expect(out[name], np.array([fn(r) for r in rows[c]], np.uint8), ok[c], name)
    _expect_rows(out["strip_multi"], [r.strip(b" ") for r in rows["multi"]], ok["multi"],
                 "strip(multi)")
    _expect(out["instr_multi"], np.array([s.find(INSTR_NEEDLE) + 1 for s in text["multi"]],
                                         np.int32), ok["multi"], "instr(multi)")
    summary["instr_multi_hits"] = int(sum(INSTR_NEEDLE in s for s in text["multi"]))

    padded, lens, back, back_lens, cp_lens = out["utf8_roundtrip"]
    if not (back.shape == padded.shape and torch.equal(back, padded)
            and torch.equal(back_lens, lens)):
        raise AssertionError("utf8 decode -> encode does not give back the padded bytes")
    if not np.array_equal(cp_lens.cpu().numpy(), np.array([len(s) for s in text["multi"]])):
        raise AssertionError("utf8 decode counts other codepoints than Python")

    _expect(out["contains_re_digits"], np.array([re.search(URL_DIGITS, s, re.ASCII) is not None
                                                 for s in text["url"]], np.uint8), ok["url"],
            "contains_re(url)")
    _expect(out["matches_re_email"], np.array([re.fullmatch(EMAIL_RE, s, re.ASCII) is not None
                                               for s in text["email"]], np.uint8), ok["email"],
            "matches_re(email)")
    matches = [re.search(EMAIL_GROUPS, s, re.ASCII) for s in text["email"]]
    for g in (0, 1, 2):
        _expect_rows(out[f"extract_re_{g}"], [m.group(g).encode() if m else b"" for m in matches],
                     ok["email"], f"extract_re(email, {g})")
    summary["extract_re_matched"] = int(sum(m is not None for m in matches))
    for lim in SPLIT_LIMITS:
        toks = out[f"split_re_{lim}"]
        want = [_java_split(s, ",", lim) for s in text["list"]]
        k = max(1, max(len(w) for w, v in zip(want, ok["list"]) if v))
        if len(toks) != k:
            raise AssertionError(f"split_re(list, {lim}) gave {len(toks)} columns, Java {k}")
        for j, tcol in enumerate(toks):
            _expect_rows(tcol, [w[j].encode() if j < len(w) else b"" for w in want],
                         ok["list"] & np.array([j < len(w) for w in want]),
                         f"split_re(list, {lim}) token {j}")
        summary[f"split_re_{lim}_columns"] = len(toks)
    _expect_rows(out["replace_re_digits"], [re.sub(r"\d+", "#", s, flags=re.ASCII).encode()
                                            for s in text["url"]], ok["url"], "replace_re(url)")
    return summary


def _capture_string_ops(run):
    """Run ``run`` once (the spark_exact or the string_ops path) with
    recorders standing in for B8's wrapper
    (``ragged_bytes.extract_strings_many``), B5's
    (``hopper_kernels.ragged_compact_many``) and the two string-tier
    functions that call them (``strings.to_padded_many``,
    ``strings.from_padded``), and restore them. The wrappers count through
    their module-level names, so their launches land on the recorders'
    counts. Returns (run's result, B8's calls, B5's calls, the predicted
    launches: one B8 launch per padding call with a column that has
    characters, one B5 launch per compaction of a nonzero total)."""
    from spark_rapids_jni_tpu_torch.ops import hopper_kernels as hk
    from spark_rapids_jni_tpu_torch.ops import ragged_bytes as rb
    from spark_rapids_jni_tpu_torch.ops import strings

    b8, b5, pad_many, from_padded = (rb.extract_strings_many, hk.ragged_compact_many,
                                     strings.to_padded_many, strings.from_padded)
    seen8, seen5 = [], []
    predicted = {"extract_strings_many": 0, "ragged_compact_many": 0}

    def b8_recorder(*args):
        seen8.append(args)
        return b8(*args)

    def b5_recorder(pool, columns, row_starts=None):
        seen5.append((pool, columns))
        return b5(pool, columns, row_starts=row_starts)

    def pad_recorder(cols):
        predicted["extract_strings_many"] += any(len(c) and c.chars.shape[0] for c in cols)
        return pad_many(cols)

    def compact_recorder(padded, lens, validity=None):
        out = from_padded(padded, lens, validity)
        predicted["ragged_compact_many"] += bool(out.chars.shape[0])
        return out

    b8_recorder.launches = b5_recorder.launches = 0
    rb.extract_strings_many, hk.ragged_compact_many = b8_recorder, b5_recorder
    strings.to_padded_many, strings.from_padded = pad_recorder, compact_recorder
    try:
        result = run()
    finally:
        rb.extract_strings_many, hk.ragged_compact_many = b8, b5
        strings.to_padded_many, strings.from_padded = pad_many, from_padded
    launches = {"extract_strings_many": b8_recorder.launches,
                "ragged_compact_many": b5_recorder.launches}
    return result, seen8, seen5, launches, predicted


def _check_b8_calls(seen8, path: str) -> list:
    """B8 against its plain version on every call ``path`` made, bit for
    bit over the whole padded width (the bytes past each length too).
    Returns the shapes checked."""
    import torch
    from spark_rapids_jni_tpu_torch.ops import ragged_bytes as rb

    shapes = []
    for pools, starts, lens, widths in seen8:
        got, want = rb.extract_strings_many(pools, starts, lens, widths), \
            rb.extract_strings_many_plain(pools, starts, lens, widths)
        if len(got) != len(want) or not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"extract_strings_many disagrees with its plain version on the "
                                 f"{path} path's arguments (widths {list(widths)})")
        shapes.append(f"{len(pools)} column(s), uint8 pool [{pools[0].shape[0]}], "
                      f"{str(starts[0].dtype).replace('torch.', '')} [{starts[0].shape[0]}] "
                      f"starts, widths {list(widths)}")
    return shapes


def _check_b5_calls(seen5, path: str) -> None:
    """B5 against its plain version on every call ``path`` made, bit for
    bit."""
    import torch
    from spark_rapids_jni_tpu_torch.ops import hopper_kernels as hk

    for pool, columns in seen5:
        got = hk.ragged_compact_many(pool, columns)
        want = [hk.ragged_compact_plain(pool, b, o, t) for b, o, t in columns]
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError("ragged_compact_many disagrees with its plain version on the "
                                 f"{path} path's arguments")


def _string_ops_kernel_phase(seen8, seen5, rate: float):
    """B8 and B5 timed on every call the path made (each checked against
    its plain version before), at the path's shapes as the string path's
    are (CUDA events around a call, B8 in turns with its library call, the
    index built outside; B5's library with its index in the timed region),
    summed over the path's launches: identical calls (the same column
    padded again) are timed once and counted as often as they ran. The
    device time of a part is its kernel's per-launch mean over a traced
    replay of its call (``_traced_ms``) times its launches. Returns the
    two kernels' entries."""
    import torch
    from spark_rapids_jni_tpu_torch.ops import hopper_kernels as hk
    from spark_rapids_jni_tpu_torch.ops import ragged_bytes as rb

    groups8 = {}
    for args in seen8:
        key = tuple((p.data_ptr(), s.data_ptr(), w) for p, s, w in zip(args[0], args[1], args[3]))
        groups8.setdefault(key, []).append(args)
    parts8 = {}
    for calls in groups8.values():
        pools, starts, lens, widths = calls[0]
        k, n = len(calls), starts[0].shape[0]
        ext, idxs = [], []
        for pool, st, ln, lc in zip(pools, starts, lens, widths):
            plen = pool.shape[0]
            span = torch.arange(lc, device=pool.device)
            i = st.to(torch.int64)[:, None] + span
            idxs.append(torch.where((span < ln.to(torch.int64)[:, None]) & (i < plen), i, plen))
            ext.append(torch.cat([pool, pool.new_zeros(1)]))

        def kernel(a=calls[0]):
            return rb.extract_strings_many(*a)

        def library(ext=ext, idxs=idxs):
            return [e[i] for e, i in zip(ext, idxs)]

        ms, lib_ms = _time_turns([kernel, library], reps=REPS)
        str_bytes = sum(int(torch.clamp(ln.to(torch.int64), 0, lc).sum())
                        for ln, lc in zip(lens, widths))
        parts8[f"{len(pools)} column(s) uint8 [{n}, {'/'.join(map(str, widths))}] x{k}"] = dict(
            launches=k, ms=k * ms, library_ms=k * lib_ms, host_us=_host_us(kernel, reps=10),
            plain_ms=k * _time_ms(lambda a=calls[0]: rb.extract_strings_many_plain(*a),
                                  reps=PLAIN_REPS, warm=1),
            bound_ms=k * (str_bytes + sum(8 * n + n * lc for lc in widths)) / rate * 1e3,
            **_traced_ms(kernel, "extract_strings_kernel", k))
        del ext, idxs
    parts5 = {}
    for i, (pool, columns) in enumerate(seen5):
        (base, offs, total), = columns
        n = base.shape[0]

        def library(pool=pool, base=base, offs=offs, total=total):
            o = offs.to(torch.int64)
            idx = torch.repeat_interleave(base - o[:-1], o[1:] - o[:-1], output_size=total)
            return pool[idx + torch.arange(total, device=pool.device)]

        parts5[f"call {i}: uint8 [{n}, {pool.shape[0] // max(n, 1)}] -> {total} B"] = dict(
            launches=1, ms=_time_ms(lambda: hk.ragged_compact_many(pool, columns)),
            host_us=_host_us(lambda: hk.ragged_compact_many(pool, columns), reps=10),
            plain_ms=_time_ms(lambda: hk.ragged_compact_plain(pool, base, offs, total),
                              reps=PLAIN_REPS, warm=1),
            library_ms=_time_ms(library, reps=PLAIN_REPS, warm=1),
            # the base and offsets read, the total's bytes read and written
            bound_ms=(8 * n + 4 * (n + 1) + 2 * int(total)) / rate * 1e3,
            **_traced_ms(lambda: hk.ragged_compact_many(pool, columns),
                         "ragged_compact_rows_kernel", 1))
    method = ("each part's per-launch device mean over the launches the tracer kept of a "
              "replay of its call (device_traced of device_calls), times its launches")
    return {
        "extract_strings_many": _combine(
            parts8, library="per column ext[idx] (the pool with a zero byte appended), index "
                            "and copy built outside the timed region, in turns with the kernel",
            device_ms_method=method),
        "ragged_compact_many": _combine(
            parts5, library="pool[repeat_interleave(base - offs[:-1], lens) + arange(total)], "
                            "index built in the timed region",
            device_ms_method=method),
    }


# ---------------------------------------------------------------------------
# the io path: Parquet and ORC bytes -> footer filter -> device Table -> rows
# ---------------------------------------------------------------------------

IO_ROWS = LINEITEM_ROWS  # TPC-H SF1's lineitem, not cut
IO_NESTED_ROWS = 1_000_000
IO_SPLIT = 128 << 20  # spark.sql.files.maxPartitionBytes
IO_KERNELS = ("extract_strings_many", "var_accumulate", "assemble_rows")
IO_SIZES = {}  # writer sizes (row groups, pages, stripes): the writers' defaults
IO_DEVICE = "cuda"  # "cpu" only to rehearse the phase without a card


def _io_writers():
    """The harness writers (``tests/torch_io_writers.py``, no jax)."""
    from pathlib import Path

    here = str(Path(__file__).resolve().parent / "tests")
    if here not in sys.path:
        sys.path.insert(0, here)
    import torch_io_writers

    return torch_io_writers


def _io_inputs(seed: int):
    """The lineitem columns (``IO_ROWS``), the nested data
    (``IO_NESTED_ROWS``) and the files written from them: {name: (bytes,
    format, row group spans or None)}."""
    w = _io_writers()
    rows, nested_rows = IO_ROWS, IO_NESTED_ROWS
    pq_sizes = {k: v for k, v in IO_SIZES.items() if k in ("row_group_bytes", "page_bytes",
                                                           "dict_bytes")}
    cols = w.lineitem_columns(rows, seed)
    files = {}
    for codec in ("snappy", None):
        spans = []
        buf = w.write_parquet(cols, codec, spans=spans, **pq_sizes)
        files[f"lineitem.parquet.{codec or 'uncompressed'}"] = (buf, "parquet", spans)
    files["lineitem.orc.zlib"] = (w.write_orc(cols, **{k: v for k, v in IO_SIZES.items()
                                                       if k in ("stripe_bytes", "block")}),
                                  "orc", None)
    nd = w.nested_data(nested_rows, seed + 1)
    files["nested.parquet.snappy"] = (
        w.write_parquet_nested(nd, "snappy", **{k: v for k, v in IO_SIZES.items()
                                                if k == "rows_per_page"}), "parquet", None)
    return cols, nd, files


def _io_read_schema(name: str, cols):
    """Spark's read schema for the footer filter: every column."""
    from spark_rapids_jni_tpu_torch.io.parquet_footer import (ListElement, StructElement,
                                                              ValueElement)

    if name.startswith("nested"):
        return (StructElement().add_child("l", ListElement(ValueElement()))
                .add_child("s", StructElement().add_child("a", ValueElement())
                           .add_child("b", ValueElement())))
    root = StructElement()
    for c in cols:
        root.add_child(c.name, ValueElement())
    return root


def _io_footers(buf, schema):
    from spark_rapids_jni_tpu_torch.io import parquet_footer as pf

    return [pf.read_and_filter(buf, off, IO_SPLIT, schema) for off in range(0, len(buf), IO_SPLIT)]


def _check_footers(footers, spans, rows: int, ncols: int) -> list:
    """Each split keeps the row groups whose midpoint falls in it (by the
    writer's own spans when it gave them), all with the read schema's
    columns, and the splits' rows sum to the file's. Returns the groups
    kept a split."""
    kept = []
    for i, f in enumerate(footers):
        off = i * IO_SPLIT
        groups = f._meta.get(4).values if f._meta.get(4) is not None else []
        kept.append(len(groups))
        if spans is not None:
            want = [r for start, size, r in spans if off <= start + size // 2 < off + IO_SPLIT]
            if len(groups) != len(want) or f.get_num_rows() != sum(want):
                raise AssertionError(f"split {i} kept {len(groups)} groups / {f.get_num_rows()} "
                                     f"rows, the midpoints say {len(want)} / {sum(want)}")
        if f.get_num_columns() != ncols:
            raise AssertionError(f"split {i} has {f.get_num_columns()} columns, not {ncols}")
    if sum(f.get_num_rows() for f in footers) != rows:
        raise AssertionError("the splits' rows do not sum to the file's")
    return kept


def _io_expected(cols, fmt: str, pdt):
    """(dtype, host data) of each lineitem column as the reader of ``fmt``
    gives it: FLOAT64 as bits; parquet widens INT8 (physical INT32) to
    INT32; dates INT32 in both."""
    kinds = {"double": pdt.FLOAT64, "date": pdt.INT32, "string": pdt.STRING,
             "int8": pdt.INT32 if fmt == "parquet" else pdt.INT8}
    out = []
    for c in cols:
        d = kinds[c.kind]
        out.append((d, c.values if c.kind == "string" else
                    np.asarray(c.values).astype(d.np_dtype) if c.kind != "double" else
                    np.asarray(c.values).view(np.uint64)))
    return out


def _check_flat_read(table, expected, names) -> None:
    """Every column bit for bit the source: dtype, no validity, data bits;
    STRING offsets and chars."""
    from spark_rapids_jni_tpu_torch.columnar import dtype as pdt

    if table.names != list(names) or table.num_columns != len(expected):
        raise AssertionError(f"read {table.names}, not {list(names)}")
    for nm, col, (d, want) in zip(names, table.columns, expected):
        if col.dtype != d or col.validity is not None:
            raise AssertionError(f"{nm}: read {col.dtype!r} (validity "
                                 f"{col.validity is not None}), not {d!r} without nulls")
        if d == pdt.STRING:
            if not (np.array_equal(col.offsets.cpu().numpy(), want[0])
                    and np.array_equal(col.chars.cpu().numpy(), want[1])):
                raise AssertionError(f"{nm}: offsets or chars differ from the source")
        elif not np.array_equal(col.to_numpy(), want):
            raise AssertionError(f"{nm}: data differs from the source")


def _check_nested_read(table, nd) -> None:
    """The nested file's columns bit for bit the source: LIST validity,
    offsets, INT64 child data and validity; STRUCT validity, the INT32
    child and the STRING child (validity, offsets, chars)."""
    def mask(col, want, what):
        got = np.ones(len(want), bool) if col.validity is None else col.validity.cpu().numpy()
        if not np.array_equal(got, want):
            raise AssertionError(f"nested {what}: validity differs from the source")

    lst, st = table.column("l"), table.column("s")
    mask(lst, nd.list_valid, "l")
    elem = lst.child
    mask(elem, nd.elem_valid, "l.element")
    if not (np.array_equal(lst.offsets.cpu().numpy(), nd.list_offsets)
            and np.array_equal(elem.to_numpy(), nd.elem_values)):
        raise AssertionError("nested l: offsets or element values differ from the source")
    mask(st, nd.struct_valid, "s")
    a, b = st.children
    mask(a, nd.a_valid, "s.a")
    mask(b, nd.b_valid, "s.b")
    if not (np.array_equal(a.to_numpy(), nd.a_values)
            and np.array_equal(b.offsets.cpu().numpy(), nd.b_offsets)
            and np.array_equal(b.chars.cpu().numpy(), nd.b_chars)):
        raise AssertionError("nested s: a, or b's offsets or chars, differ from the source")


def _table_bytes(table) -> int:
    """Decoded bytes of a table: every data, offsets, chars and validity
    buffer, children included."""
    def col_bytes(c):
        n = 0
        for t in (c.data, c.validity, c.offsets, c.chars):
            if t is not None:
                n += t.numel() * t.element_size()
        kids = ([c.child] if c.child is not None else []) + list(c.children or ())
        return n + sum(col_bytes(k) for k in kids)

    return sum(col_bytes(c) for c in table.columns)


def _io_direct_rows(expected, names, device):
    """convert_to_rows of the source arrays uploaded directly, the oracle of
    the read table's rows."""
    from spark_rapids_jni_tpu_torch.columnar import Column, Table
    from spark_rapids_jni_tpu_torch.columnar import dtype as pdt
    from spark_rapids_jni_tpu_torch.ops import row_conversion as rc

    cols = [Column.strings_from_parts(*want, device=device) if d == pdt.STRING
            else Column.from_numpy(want.view(np.float64) if d == pdt.FLOAT64 else want, d,
                                   device=device)
            for d, want in expected]
    return rc.convert_to_rows(Table(cols, names))


def _same_columns(a, b) -> bool:
    import torch

    def same(x, y):
        if (x is None) != (y is None):
            return False
        return x is None or (x.dtype == y.dtype and torch.equal(x, y))

    return all(ca.dtype == cb.dtype and all(same(getattr(ca, f), getattr(cb, f)) for f in
                                            ("data", "validity", "offsets", "chars"))
               for ca, cb in zip(a.columns, b.columns)) and a.num_columns == b.num_columns


def _io_path(buf, fmt: str, schema, lineitem: bool):
    """One file through the path: the footer filter for every split
    (parquet), read_table onto the card, and for lineitem convert_to_rows
    and the frames with checks on and off. Returns (footers, table, rows,
    frames {checked: (bytes, decoded table)}, host ms by stage)."""
    import torch
    from spark_rapids_jni_tpu_torch.columnar import frames
    from spark_rapids_jni_tpu_torch.io import orc_reader, parquet_reader
    from spark_rapids_jni_tpu_torch.ops import row_conversion as rc
    from spark_rapids_jni_tpu_torch.utils import integrity

    stage = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stage[f"{name}_ms"] = (time.perf_counter() - t0) * 1e3
        return out

    footers = timed("footer", lambda: _io_footers(buf, schema)) if fmt == "parquet" else None
    reader = parquet_reader if fmt == "parquet" else orc_reader
    table = timed("read", lambda: reader.read_table(buf, device=IO_DEVICE))
    rows, fr = None, {}
    if lineitem:
        rows = timed("to_rows", lambda: rc.convert_to_rows(table))
        for checked in (True, False):
            with (integrity.enabled() if checked else integrity.disabled()):
                sfx = "" if checked else "_unchecked"
                enc = timed("frame_encode" + sfx, lambda: frames.encode_table(table))
                fr[checked] = (enc, timed("frame_decode" + sfx,
                                          lambda: frames.decode_table(enc, device=IO_DEVICE)))
    stage["end_to_end_ms"] = sum(stage.values())
    return footers, table, rows, fr, stage


def _check_io_frames(table, fr) -> dict:
    """The frames decode to the read table bit for bit, checked and not;
    with checks on, one flipped payload byte raises DataCorruption."""
    from spark_rapids_jni_tpu_torch.columnar import frames
    from spark_rapids_jni_tpu_torch.utils import integrity
    from spark_rapids_jni_tpu_torch.utils.errors import DataCorruption

    for checked, (enc, dec) in fr.items():
        if not _same_columns(dec, table):
            raise AssertionError(f"the frame (checks {'on' if checked else 'off'}) decodes to "
                                 "another table")
    enc = fr[True][0]
    bad = bytearray(enc)
    bad[len(bad) // 2] ^= 0x10  # a payload byte (the header is a few hundred bytes)
    with integrity.enabled():
        try:
            frames.decode_table(bytes(bad), device=IO_DEVICE)
        except DataCorruption:
            pass
        else:
            raise AssertionError("a flipped payload byte decoded without DataCorruption")
    return {"frame_bytes": len(enc), "frame_bytes_unchecked": len(fr[False][0]),
            "crc": integrity.checksum_name()}


def _io_capture(run):
    """``run`` once under ``_capture_string_kernels``: (its result, the
    string kernels' recorded calls)."""
    box = []
    seen = _capture_string_kernels(lambda: box.append(run()))
    return box[0], seen


def _check_io_calls(seen) -> dict:
    """B8, B9 and B10 against their plain versions, bit for bit, on every
    call the counted run made; no decode kernel called."""
    import torch
    from spark_rapids_jni_tpu_torch.ops import ragged_bytes as rb

    plains = {"extract_strings_many": rb.extract_strings_many_plain,
              "var_accumulate": rb.var_accumulate_plain, "assemble_rows": rb.assemble_rows_plain}
    shapes = {}
    for k, plain in plains.items():
        for fn, args, kwargs in seen[k]:
            got, want = fn(*args, **kwargs), plain(*args, **kwargs)
            if isinstance(got, list):
                ok = len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))
            else:
                ok = torch.equal(got, want)
            if not ok:
                raise AssertionError(f"{k} disagrees with its plain version on the io path's call")
        shapes[k] = len(seen[k])
    others = {k: len(v) for k, v in seen.items() if k not in plains and v}
    if others:
        raise AssertionError(f"the io path called decode kernels: {others}")
    return shapes


def _io_stage_fns(buf, fmt, schema, table, enc):
    """The stages of a warm run, each a callable."""
    from spark_rapids_jni_tpu_torch.columnar import frames
    from spark_rapids_jni_tpu_torch.io import orc_reader, parquet_reader
    from spark_rapids_jni_tpu_torch.ops import row_conversion as rc

    reader = parquet_reader if fmt == "parquet" else orc_reader
    fns = {}
    if fmt == "parquet":
        fns["footer"] = lambda: _io_footers(buf, schema)
    fns["read"] = lambda: reader.read_table(buf, device=IO_DEVICE)
    if enc is not None:
        fns["to_rows"] = lambda: rc.convert_to_rows(table)
        fns["frame_encode"] = lambda: frames.encode_table(table)
        fns["frame_decode"] = lambda: frames.decode_table(enc, device=IO_DEVICE)
    return fns


# where the read's host time goes: cProfile's cumulative time of these
# functions of the readers (its overhead inflates the Python-heavy ones)
_READ_PARTS = {
    "page_headers": ("parquet_reader.py", "_read_page_header"),
    "decompress": ("parquet_reader.py", "_decompress"),
    "uploads": ("column.py", "upload"),
    "byte_array_walk": ("codecs.py", "byte_array_lens"),
    "rle_run_directory": ("parquet_reader.py", "_parse_rle_runs"),
    "levels": ("parquet_reader.py", "_read_rle_bitpacked"),
    "index_expand": ("parquet_reader.py", "_rle_expand_device"),
    "dictionary_take": ("parquet_reader.py", "take"),
    "plain_strings": ("parquet_reader.py", "_byte_array_chars_device"),
    "slot_scatter": ("parquet_reader.py", "_leaf_column"),
    "orc_deframe": ("orc_reader.py", "_deframe"),
    "orc_int_rle": ("orc_reader.py", "_rle_v2"),
    "orc_byte_rle": ("orc_reader.py", "_byte_rle"),
    "orc_strings": ("orc_reader.py", "_to_column_normalized"),
}


def _host_breakdown(fn) -> dict:
    """One warm call of ``fn`` under cProfile (ending in a synchronize):
    the wall ms of the call and the cumulative ms of each of
    ``_READ_PARTS`` that it reached."""
    import cProfile
    import pstats

    import torch

    prof = cProfile.Profile()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    out = {"profiled_ms": (time.perf_counter() - t0) * 1e3}
    stats = pstats.Stats(prof).stats
    for part, (file, func) in _READ_PARTS.items():
        hits = [v for (f, _line, name), v in stats.items() if f.endswith(file) and name == func]
        if hits:
            out[f"{part}_ms"] = sum(v[3] for v in hits) * 1e3
            out[f"{part}_calls"] = sum(v[1] for v in hits)
    return out


def _io_measure(name, fns, first, file_bytes: int, decoded: int) -> dict:
    """Per stage: warm median of 3 host ms (each run ending in a
    synchronize), GB/s (the read: file and decoded bytes; the others:
    decoded bytes), peak GiB, the H2D copies and bytes of one run through
    ``columnar.column.upload``, and a profile (device busy, idle share,
    device activities) of every stage but the footer filter, which is host
    code."""
    import torch
    from spark_rapids_jni_tpu_torch.columnar import column

    out = {}
    for st, fn in fns.items():
        torch.cuda.reset_peak_memory_stats()
        runs = []
        for _ in range(3):
            h0 = dict(column.H2D)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        ms = float(np.median(runs))
        h2d = {k: column.H2D[k] - h0[k] for k in h0}
        peak = torch.cuda.max_memory_allocated() / 2**30
        rates = {"decoded_gb_s": decoded / ms / 1e6}
        if st == "read":
            rates["file_gb_s"] = file_bytes / ms / 1e6
        print(f"io {name} {st} (host clock, ms): first run {first[st + '_ms']:.2f}; warm median of "
              f"3 {ms:.2f}; " + ", ".join(f"{k} {v:.3f}" for k, v in rates.items())
              + f"; H2D {h2d['copies']} copies, {h2d['bytes']} B; peak device memory "
              f"{peak:.2f} GiB", flush=True)
        prof = None  # the footer filter is host code: nothing to trace on the card
        if st != "footer":
            print(f"io {name} profile of {st}:", flush=True)
            prof = _profile_phase(fn, top=4)
        out[st] = {"first_ms": first[st + "_ms"], "warm_ms": ms, **rates, "h2d_copies": h2d["copies"],
                   "h2d_bytes": h2d["bytes"], "peak_gib": peak, "profile": prof}
        if st == "read":
            out[st]["host"] = _host_breakdown(fn)
            host = out[st]["host"]
            print(f"io {name} read under cProfile (cumulative ms / calls): " + ", ".join(
                f"{k[:-3]} {v:.1f}" + (f" / {host[k[:-3] + '_calls']}" if k[:-3] + "_calls" in host
                                       else "")
                for k, v in host.items() if k.endswith("_ms")), flush=True)
    return out


def _io_phase(wrappers) -> tuple:
    """The io path on every file: counted runs (the three to-rows kernels
    once each on a lineitem file, no kernel on the nested one), every
    check, then the stages measured. Returns (paths entry, launches summed
    over the files)."""
    import torch
    from spark_rapids_jni_tpu_torch.columnar import dtype as pdt
    from spark_rapids_jni_tpu_torch.io import codecs
    from spark_rapids_jni_tpu_torch.utils import integrity

    t_phase = time.perf_counter()
    cols, nd, files = _io_inputs(SEED + 12)
    names = [c.name for c in cols]
    print(f"io input: lineitem {len(cols[0])} rows x {len(cols)} columns ("
          + ", ".join(f"{k} {len(v[0])} B" for k, v in files.items())
          + f"), nested {len(nd.list_valid)} rows; written in {time.perf_counter() - t_phase:.1f} s; "
          f"frames' CRC {integrity.checksum_name()}", flush=True)
    out, launches_all = {"files": {}}, {k: 0 for k in wrappers}
    for name, (buf, fmt, spans) in files.items():
        t_file = time.perf_counter()
        lineitem = name.startswith("lineitem")
        schema = _io_read_schema(name, cols)
        ccalls0 = dict(codecs.CALLS)
        ((footers, table, rows, fr, stage), seen), launches = _run_counted(
            wrappers, lambda: _io_capture(lambda: _io_path(buf, fmt, schema, lineitem)))
        ccalls = {k: codecs.CALLS[k] - ccalls0[k] for k in ccalls0}
        for k, v in launches.items():
            launches_all[k] += v
        want = {k: (1 if lineitem and k in IO_KERNELS else 0) for k in wrappers}
        if launches != want:
            raise AssertionError(f"io {name} launched {launches}, not {want}")
        info = {"bytes": len(buf), "format": fmt, "launches": launches, "codec_calls": ccalls}
        if name.endswith("snappy") and not ccalls["snappy"]:
            raise AssertionError(f"io {name}: the native snappy codec decoded no page")
        if footers is not None:
            info["groups_per_split"] = _check_footers(
                footers, spans, len(nd.list_valid) if not lineitem else len(cols[0]),
                len(cols) if lineitem else 2)
        if lineitem:
            expected = _io_expected(cols, fmt, pdt)
            _check_flat_read(table, expected, names)
            direct = _io_direct_rows(expected, names, IO_DEVICE)
            if len(rows) != len(direct) or not all(
                    torch.equal(a.child.data, b.child.data) and torch.equal(a.offsets, b.offsets)
                    for a, b in zip(rows, direct)):
                raise AssertionError(f"io {name}: the rows of the read table differ from the "
                                     "rows of the source uploaded directly")
            info["row_bytes"] = int(sum(int(r.offsets[-1]) for r in rows))
            del direct
            info["kernel_calls"] = _check_io_calls(seen)
            info.update(_check_io_frames(table, fr))
        else:
            _check_nested_read(table, nd)
        del seen
        decoded = _table_bytes(table)
        info["decoded_bytes"] = decoded
        print(f"io {name}: {len(buf)} B, {decoded} B decoded; launches {launches}; native codec "
              f"calls {ccalls}; checks passed (footer splits {info.get('groups_per_split')}, every "
              f"column bit for bit the source" + (", rows byte-identical to the direct upload's, "
                                                 "B8/B9/B10 equal to their plain versions, frames "
                                                 "bit-identical checked and not, a flipped byte "
                                                 "raised DataCorruption" if lineitem else "")
              + ")", flush=True)
        fns = _io_stage_fns(buf, fmt, schema, table, fr[True][0] if lineitem else None)
        info["stages"] = _io_measure(name, fns, stage, len(buf), decoded)
        info["first"] = stage
        del footers, table, rows, fr, fns
        torch.cuda.empty_cache()
        info["wall_s"] = time.perf_counter() - t_file
        out["files"][name] = info
    out["phase_wall_s"] = time.perf_counter() - t_phase
    out["rows"], out["nested_rows"] = len(cols[0]), len(nd.list_valid)
    print(f"io phase: {out['phase_wall_s']:.1f} s wall (writers, counted runs, checks, warm runs, "
          f"profiles)", flush=True)
    return out, launches_all


def _warm_and_profile(prefix: str, ops, stage, watch):
    """Each of a path's operations warm (median of 3 host-clock runs, each
    ending in a synchronize; peak device memory) and then profiled, with
    ``watch`` as in ``_profile_phase``. ``stage`` holds the first runs.
    Returns (warm ms by op with their sum, peak GiB by op, profiles)."""
    import torch

    warm, peak = {}, {}
    for name, op in ops.items():
        torch.cuda.reset_peak_memory_stats()
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            op()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        warm[f"{name}_ms"] = float(np.median(runs))
        peak[name] = torch.cuda.max_memory_allocated() / 2**30
        print(f"{prefix} {name} (host clock, ms): first run {stage[name + '_ms']:.2f}; warm "
              f"median of 3 {warm[name + '_ms']:.2f}; peak device memory {peak[name]:.2f} GiB",
              flush=True)
    warm["end_to_end_ms"] = sum(warm.values())
    profiles = {}
    for name, op in ops.items():
        print(f"{prefix} profile of {name}:", flush=True)
        profiles[name] = _profile_phase(op, top=4, watch=watch)
    return warm, peak, profiles


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
        if "activities_per_call" in r:
            dev += (f", {r['activities_per_call']:g} device activities a call "
                    f"({r['device_call_ms']:.4f} ms)")
        print(f"kernel {k} [{r.get('shape', '; '.join(r.get('parts', {})))}]: {r['ms']:.4f} ms{dev} "
              f"(plain {r['plain_ms']:.4f}, library {lib}, bound {r['bound_ms']:.4f} by "
              f"{r['bound_by']}), max abs err {r['max_abs_err']}", flush=True)
        if "layouts_ms" in r:
            print(f"kernel {k} by layout (ms): {r['layouts_ms']}", flush=True)
        if "function_level" in r:
            f = r["function_level"]
            print(f"kernel {k}, function-level {f['name']} [{f['shape']}]: {f['ms']:.4f} ms, "
                  f"device {f['device_ms']:.4f} ms (plain {f['plain_ms']:.4f}, bound "
                  f"{f['bound_ms']:.4f} by {f['bound_by']}), max abs err {f['max_abs_err']}",
                  flush=True)


def _kernels_only(rate: float) -> dict:
    """B3 on the fixed path's keys and B1, B4 and B3 on the join path's
    (``--kernels-only``): the same phases and inputs as a whole run,
    without the paths, so that another checkout's wrappers can be timed
    by copying this script into its root. Its B3 may enqueue more than
    one device activity a call, so that is recorded, not checked."""
    import torch
    from spark_rapids_jni_tpu_torch.columnar import Table
    from spark_rapids_jni_tpu_torch.columnar import dtype as pdt
    from spark_rapids_jni_tpu_torch.interop import carry_table
    from spark_rapids_jni_tpu_torch.parallel import shuffle

    rng = np.random.default_rng(SEED)  # the fixed path's key and value, drawn as _host_table does
    keys = torch.from_numpy(rng.integers(0, NUM_KEYS, ROWS, dtype=np.int64)).cuda()
    vals = torch.from_numpy(rng.standard_normal(ROWS, dtype=np.float32)).cuda()
    b3 = _b3_phase(keys, vals, rate, check_one=False)
    (fa, fv), (da, dv) = _join_inputs(SEED + 2)
    fact = Table(carry_table(fa, [_pdtype(pdt, t) for _, t in FACT_COLS], fv, device="cuda").columns,
                 [n for n, _ in FACT_COLS])
    dim = Table(carry_table(da, [_pdtype(pdt, t) for _, t in DIM_COLS], dv, device="cuda").columns,
                [n for n, _ in DIM_COLS])
    part, _ = shuffle.hash_partition(fact, PARTITIONS, ["item_sk"])
    out = _join_kernel_phase(fact, part, dim, rate, check_one=False)
    b3["join_keys"] = out.pop("groupby_sum_outer")
    return {"groupby_sum_outer": b3, **out}


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
    device = {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}
    if "--kernels-only" in sys.argv[1:]:
        small = _kernels_only(rate)
        _print_kernels({**small, "groupby_sum_outer (join keys)": small["groupby_sum_outer"]["join_keys"]})
        print(json.dumps({"kernels_only": small, "card": smi_line}), flush=True)
        return 4  # a partial run: no path was driven
    wrappers = {"expand_u32_planes": rb.expand_u32_planes, "rows_to_planes": rb.rows_to_planes,
                "groupby_sum_outer": hk.groupby_sum_outer,
                "extract_strings_many": rb.extract_strings_many,
                "var_accumulate": rb.var_accumulate, "assemble_rows": rb.assemble_rows,
                "ragged_compact_many": hk.ragged_compact_many, "partition_map": hk.partition_map,
                "probe_paged": hk.probe_paged, "groupby_sum_bounded": hk.groupby_sum_bounded,
                # the function-level entries of B7, B8, B10 and B5, which no path launches now
                "pack_u8_planes": rb.pack_u8_planes, "rotl_take": rb.rotl_take,
                "asm_epilogue": rb.asm_epilogue, "ragged_compact": hk.ragged_compact}
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
    for k in FIXED_PATH_KERNELS:
        if launches[k] < 1:
            raise AssertionError(f"the fixed path never launched {k}")
    if launches["rows_to_planes"] != 1:
        raise AssertionError(f"the fixed path launched rows_to_planes {launches['rows_to_planes']} "
                             "times, not once")
    for k in PATH_NEVER:
        if launches[k]:
            raise AssertionError(f"the fixed path launched {k}, which it no longer runs")
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
    profile = _profile_phase(run_fixed, top=10, watch={
        "rows_to_planes_kernel": rb.rows_to_planes, "expand_kernel": rb.expand_u32_planes,
        "pack_kernel": rb.pack_u8_planes, "rotl_take_kernel": rb.rotl_take,
        "groupby_outer_kernel": hk.groupby_sum_outer})
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
    for k in STRING_PATH_ONCE:
        if slaunches[k] != 1:
            raise AssertionError(f"the string path launched {k} {slaunches[k]} times, not once")
    for k in PATH_NEVER:
        if slaunches[k]:
            raise AssertionError(f"the string path launched {k}, which it no longer runs")
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
    sprofile = _profile_phase(run_strings, top=14, watch={
        "extract_strings_kernel": rb.extract_strings_many,
        "var_accumulate_tile_kernel": rb.var_accumulate, "assemble_rows_kernel": rb.assemble_rows,
        "rows_to_planes_kernel": rb.rows_to_planes,
        "ragged_compact_rows_kernel": hk.ragged_compact_many,
        "groupby_outer_kernel": hk.groupby_sum_outer, "rotl_take_kernel": rb.rotl_take,
        "pack_kernel": rb.pack_u8_planes})
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
    kernels["groupby_sum_outer"]["join_keys"] = jkernels.pop("groupby_sum_outer")

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
    jprofile = _profile_phase(run_join, top=14, watch={
        "partition_map_kernel": hk.partition_map, "probe_fenced_kernel": hk.probe_paged,
        "groupby_outer_kernel": hk.groupby_sum_outer})
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
    # the card, no fill and no copy
    oacts = _one_activity(lambda: hk.groupby_sum_bounded(okeys, ovals, NUM_KEYS),
                          "groupby_bounded_kernel", hk.groupby_sum_bounded)
    print(f"onehot path under the profiler: {[(name[:80], us) for name, us in oacts]}", flush=True)
    oerr = _check_onehot(okeys_h, ovals_h, osums)
    owarm = _warm_stages(run_onehot)
    print(f"onehot path checked against np.bincount in float64: max abs err {oerr:.3g}; host ms: "
          f"first run {_fmt_stages(ostage)}; warm median of 3 {_fmt_stages(owarm)}", flush=True)
    paths["onehot"] = {**ostage, "warm": owarm, "warm_end_to_end_ms": owarm["end_to_end_ms"],
                       "rows": ONEHOT_ROWS, "num_keys": NUM_KEYS, "max_abs_err": oerr,
                       "launches": olaunches, "device_activities": oacts}
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

    # -- the tpcds path: the single-chip TPC-DS queries ----------------------
    t_phase = time.perf_counter()
    stars = _tpcds_inputs()
    torch.cuda.synchronize()
    print(f"tpcds input: store_sales {TPCDS_ROWS['store10']} rows (SF10: q3) and "
          f"{TPCDS_ROWS['store1']} rows twice (SF1: q42, q52, q55, q98; the wide star of q7 and "
          f"q19), web_sales {TPCDS_ROWS['web10']} rows (SF10: q95) and {TPCDS_ROWS['web1']} rows "
          f"(SF1: q94), made on the host and uploaded in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    (dout, dstage), dlaunches = _run_counted(wrappers, lambda: _tpcds_path(stars))
    print(f"tpcds path launches: {dlaunches}", flush=True)
    dsizes = _check_tpcds(stars, dout)
    print(f"tpcds path checked against the numpy oracles (group keys, order and counts exact, "
          f"every sum, mean, ratio and total bit-identical to the exact rational): result rows "
          f"(q94/q95: orders) {dsizes}", flush=True)
    del dout
    dwarm, dpeak = {}, {}
    for q, _ in TPCDS_QUERIES:
        torch.cuda.reset_peak_memory_stats()
        dwarm[f"{q}_ms"] = float(np.median([_tpcds_query(q, stars)[1] for _ in range(3)]))
        dpeak[q] = torch.cuda.max_memory_allocated() / 2**30
    dwarm["end_to_end_ms"] = sum(dwarm.values())
    for q, _ in TPCDS_QUERIES:
        print(f"tpcds {q} (host clock, ms): first run {dstage[q + '_ms']:.2f}; warm median of 3 "
              f"{dwarm[q + '_ms']:.2f}; peak device memory {dpeak[q]:.2f} GiB", flush=True)
    dprofiles = {}
    for q, _ in TPCDS_QUERIES:
        print(f"tpcds profile of {q}:", flush=True)
        dprofiles[q] = _profile_phase(lambda: _tpcds_query(q, stars),
                                      top=10 if q in ("q3", "q95") else 4)
    dwall = time.perf_counter() - t_phase
    print(f"tpcds phase: {dwall:.1f} s wall (input, counted run, checks, warm runs, profiles)",
          flush=True)
    paths["tpcds"] = {**dstage, "warm": dwarm, "warm_end_to_end_ms": dwarm["end_to_end_ms"],
                      "rows": TPCDS_ROWS, "result_rows": dsizes, "peak_gib": dpeak,
                      "phase_wall_s": dwall, "launches": dlaunches, "profile": dprofiles}
    del stars
    torch.cuda.empty_cache()

    # -- the spark_exact path: the reference's Spark-exact operators ---------
    t_phase = time.perf_counter()
    xh, xt = _spark_exact_inputs(SEED + 10)
    torch.cuda.synchronize()
    print(f"spark_exact input: {SPARK_ROWS} rows of integer strings ({int(xt.column('ints').offsets[-1])} "
          f"B), decimal strings ({int(xt.column('decs').offsets[-1])} B), DECIMAL(38, 10) operand "
          f"pairs, 3 INT32 range-id and 4 INT64 Z-order columns, UINT32 and UINT64 columns, made "
          f"and uploaded in {time.perf_counter() - t_phase:.1f} s", flush=True)
    xops = _spark_exact_ops(xt)
    # the counted run records the arguments the casts hand B8's wrapper
    # (through strings.to_padded)
    ((xout, xstage), xseen, _, rec, predicted), xlaunches = _run_counted(
        wrappers, lambda: _capture_string_ops(lambda: _spark_exact_path(xops)))
    xlaunches["extract_strings_many"] += rec["extract_strings_many"]
    print(f"spark_exact path launches: {xlaunches}", flush=True)
    if not len(xseen) == xlaunches["extract_strings_many"] == predicted["extract_strings_many"]:
        raise AssertionError(f"recorded {len(xseen)} extract_strings_many calls, counted "
                             f"{xlaunches['extract_strings_many']} launches, predicted "
                             f"{predicted['extract_strings_many']}")
    xb8_shapes = _check_b8_calls(xseen, "spark_exact")
    del xseen
    print(f"spark_exact: extract_strings_many equals its plain version bit for bit on all "
          f"{len(xb8_shapes)} of the path's calls: {xb8_shapes}", flush=True)
    if xlaunches["extract_strings_many"] < 2:
        raise AssertionError("the spark_exact path launched extract_strings_many "
                             f"{xlaunches['extract_strings_many']} times, not once a cast")
    others = {k: v for k, v in xlaunches.items() if k != "extract_strings_many" and v}
    if others:
        raise AssertionError(f"the spark_exact path launched kernels it does not run: {others}")
    t0 = time.perf_counter()
    xcheck = _check_spark_exact(xh, xt, xout)
    print(f"spark_exact path checked against the independent oracles in "
          f"{time.perf_counter() - t0:.1f} s (Python ints and decimal rules, numpy's unsigned "
          f"arithmetic, Delta's interleaveBits; the ANSI cast raised CastError on row "
          f"{xcheck['ansi_row']} '12x4'): {xcheck}", flush=True)
    del xout
    xwarm, xpeak, xprofiles = _warm_and_profile(
        "spark_exact", xops, xstage, {"extract_strings_kernel": rb.extract_strings_many})
    xwall = time.perf_counter() - t_phase
    print(f"spark_exact phase: {xwall:.1f} s wall (input, counted run, checks, warm runs, "
          f"profiles)", flush=True)
    paths["spark_exact"] = {**xstage, "warm": xwarm, "warm_end_to_end_ms": xwarm["end_to_end_ms"],
                            "rows": SPARK_ROWS, **xcheck, "peak_gib": xpeak,
                            "extract_strings_checked": xb8_shapes,
                            "phase_wall_s": xwall, "launches": xlaunches, "profile": xprofiles}
    del xh, xt, xops
    torch.cuda.empty_cache()

    # -- the string_ops path: the string and regex tier ----------------------
    t_phase = time.perf_counter()
    sh, st = _string_ops_inputs(SEED + 11)
    torch.cuda.synchronize()
    print(f"string_ops input: {SOPS_ROWS} rows x 4 STRING columns (" + ", ".join(
        f"{k} {int(st.column(k).offsets[-1])} B" for k in ("email", "url", "multi", "list"))
        + f"; {SOPS_NULLS:.0%} nulls each), made and uploaded in "
        f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    sops = _string_ops(st)
    ((sout, sostage), seen8, seen5, rec, predicted), solaunches = _run_counted(
        wrappers, lambda: _capture_string_ops(lambda: _spark_exact_path(sops)))
    for k, v in rec.items():
        solaunches[k] += v
    print(f"string_ops path launches: {solaunches}; predicted by the calls: {predicted}",
          flush=True)
    for k, v in predicted.items():
        if solaunches[k] != v or len(seen8 if k == "extract_strings_many" else seen5) != v:
            raise AssertionError(f"the string_ops path launched {k} {solaunches[k]} times "
                                 f"({len(seen8)} / {len(seen5)} calls recorded), not {v}")
    others = {k: v for k, v in solaunches.items() if k not in predicted and v}
    if others:
        raise AssertionError(f"the string_ops path launched kernels it does not run: {others}")
    t0 = time.perf_counter()
    socheck = _check_string_ops(sh, sout)
    print(f"string_ops path checked against the per-row oracles (bytes / str methods, re under "
          f"re.ASCII, Java's split) in {time.perf_counter() - t0:.1f} s: {socheck}", flush=True)
    print(f"string_ops rows where Spark's semantics differ from the reference's: length(multi) "
          f"{socheck['length_multi_spark_differs']}, substring(multi, 2, 3) "
          f"{socheck['substring_multi_spark_differs']} (bytes against characters), upper(multi) "
          f"{socheck['upper_multi_spark_differs']}, lower(multi) "
          f"{socheck['lower_multi_spark_differs']} (the 1:1 case map)", flush=True)
    del sout
    _check_b8_calls(seen8, "string_ops")
    _check_b5_calls(seen5, "string_ops")
    print(f"string_ops: extract_strings_many equals its plain version bit for bit on all "
          f"{len(seen8)} calls, ragged_compact_many on all {len(seen5)}", flush=True)
    sok = _string_ops_kernel_phase(seen8, seen5, rate)
    del seen8, seen5
    _print_kernels({f"{k} (string_ops)": r for k, r in sok.items()})
    sowarm, sopeak, soprofiles = _warm_and_profile(
        "string_ops", sops, sostage, {"extract_strings_kernel": rb.extract_strings_many,
                                      "ragged_compact_rows_kernel": hk.ragged_compact_many})
    for k in sok:
        skernels[k]["string_ops"] = sok[k]
    sowall = time.perf_counter() - t_phase
    print(f"string_ops phase: {sowall:.1f} s wall (input, counted run, checks, kernel checks, "
          f"warm runs, profiles)", flush=True)
    paths["string_ops"] = {**sostage, "warm": sowarm, "warm_end_to_end_ms": sowarm["end_to_end_ms"],
                           "rows": SOPS_ROWS, **socheck, "peak_gib": sopeak,
                           "predicted_launches": predicted, "phase_wall_s": sowall,
                           "launches": solaunches, "profile": soprofiles}
    del sh, st, sops
    torch.cuda.empty_cache()

    # -- the io path: Parquet and ORC bytes -> footer -> Table -> rows -------
    paths["io"], iolaunches = _io_phase(wrappers)
    torch.cuda.empty_cache()

    # rows_to_planes runs on both transcode paths: its entry sums the two
    kernels["rows_to_planes"] = _combine(
        {**kernels["rows_to_planes"]["parts"], **skernels.pop("rows_to_planes")["parts"]},
        function_level=kernels["rows_to_planes"]["function_level"])
    csrc = "spark_rapids_jni_tpu_torch/csrc/"
    sources = {"expand_u32_planes": csrc + "planes.cu", "rows_to_planes": csrc + "planes.cu",
               "groupby_sum_outer": csrc + "groupby.cu", "extract_strings_many": csrc + "strings.cu",
               "var_accumulate": csrc + "strings.cu", "assemble_rows": csrc + "strings.cu",
               "ragged_compact_many": csrc + "strings.cu", "partition_map": csrc + "partition.cu",
               "probe_paged": csrc + "join.cu", "groupby_sum_bounded": csrc + "groupby.cu"}
    replaces = {"expand_u32_planes": "spark_rapids_jni_tpu/ops/ragged_bytes.py:185",
                "rows_to_planes": "spark_rapids_jni_tpu/ops/ragged_bytes.py:208",
                "groupby_sum_outer": "spark_rapids_jni_tpu/ops/pallas_kernels.py:416",
                "extract_strings_many": "spark_rapids_jni_tpu/ops/ragged_bytes.py:324",
                "var_accumulate": "spark_rapids_jni_tpu/ops/ragged_bytes.py:405",
                "assemble_rows": "spark_rapids_jni_tpu/ops/ragged_bytes.py:465",
                "ragged_compact_many": "spark_rapids_jni_tpu/ops/pallas_kernels.py:927",
                "partition_map": "spark_rapids_jni_tpu/ops/pallas_kernels.py:178",
                "probe_paged": "spark_rapids_jni_tpu/ops/pallas_kernels.py:713",
                "groupby_sum_bounded": "spark_rapids_jni_tpu/ops/pallas_kernels.py:287"}
    # launches: the count on the path whose shapes the times are from
    # (B3/B6 the fixed path, the string kernels the string path, B1/B4 the
    # join path, B2 the onehot path; rows_to_planes both transcode paths)
    timed_on = {**{k: launches[k] for k in kernels}, **{k: slaunches[k] for k in skernels},
                **{k: jlaunches[k] for k in jkernels}, **{k: olaunches[k] for k in okernels},
                "rows_to_planes": launches["rows_to_planes"] + slaunches["rows_to_planes"]}
    # what else of the TPU package a redesigned kernel took over
    absorbs = {"rows_to_planes": "spark_rapids_jni_tpu/ops/ragged_bytes.py:324 (B8 as the decode "
                                 "ran it: padded_extract's tile gather and rotate of the rows' "
                                 "fixed sections)",
               "assemble_rows": "the reference's tiling around _asm_epilogue (assemble_tiles)"}
    line = {"kernels": [
        {"name": k, "route": "cuda", "source": sources[k], "replaces": replaces[k],
         **({"absorbs": absorbs[k]} if k in absorbs else {}),
         "launches": timed_on[k],
         "launches_by_path": {"fixed": launches[k], "strings": slaunches[k], "join": jlaunches[k],
                              "onehot": olaunches[k], "tpch": tlaunches[k],
                              "tpcds": dlaunches[k], "spark_exact": xlaunches[k],
                              "string_ops": solaunches[k], "io": iolaunches[k]},
         "max_abs_err": r["max_abs_err"], "ms": r["ms"], "kernel_ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"],
         **{x: r[x] for x in ("library", "parts", "device_ms", "host_us", "library_host_us",
                              "max_abs_err_vs_b3", "layouts_ms", "function_level",
                              "bound_ms_int64_base", "device_call_ms", "activities_per_call",
                              "one_call_activities", "join_keys", "string_ops") if x in r}}
        for k, r in {**kernels, **skernels, **jkernels, **okernels}.items()
    ], "paths": paths, "card": smi_line}
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
