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
11. the DISTRIBUTED path, the in-mesh tier (``parallel/``), run right
   after the tpcds path on its stars: a mesh of 8 shards on the one card
   (``make_mesh({"data": 8}, devices=[cuda:0] * 8)``, the stand-in for the
   reference's forced host devices) and, once, ``make_mesh()``'s default of
   one shard a card. ``distributed_groupby_sum`` of 1,048,576 INT64 keys
   uniform in [0, 4096) with INT64 values in [0, 1000), and ``_multi`` on
   (key % 64, key // 64) as INT32, exact against numpy with each group's
   shard and order; ``exchange_by_key`` of the join path's fact batch on
   ``item_sk`` (every row on shard pmod(murmur3(item_sk), 8), in row
   order, bit for bit with validity), the raise / flag / retry contracts
   at a shard's rows / 64, and one flipped value in a received bucket
   raising ``DataCorruption``; ``exchange_table`` of the item dimension on
   ``i_brand_id`` (a permutation, strings byte for byte);
   ``distributed_inner_join`` of the fact's non-null ``item_sk`` with the
   dimension's (the (key, left, right) multiset exact);
   ``distributed_sort`` of 1,048,576 INT64 keys, uniform and 90% one key,
   ascending and descending, against ``np.sort``; and q7, q19, q52, q55
   (SF1) and q94, q95 (SF10) ``*_distributed``, bit for bit the single-chip
   results on the same tables. The counted run records every B1 call (the
   single-key routing): each is held against ``partition_map_plain`` bit
   for bit, their count must be what the routing rule predicts from the
   routing calls, and no other kernel may launch. Per operation: first-run
   and warm median-of-3 host ms, peak memory and a profile (device busy,
   idle share, launches); each exchange's padded wire bytes against its
   dense bytes; the phase's wall seconds;
12. the RUNTIME path, the op boundary (``utils/dispatch.op_boundary``)
   and the runtime core around the paths above, at their full sizes. On
   the fixed and join paths' tables: one run each with metrics and
   tracing armed inside one root trace, with every launch counter at 0,
   bit for bit the disarmed run (the float32 sums within the path's
   tolerance, their bit identity reported: B3 adds float64 atomics in no
   fixed order), ``op.<name>.calls`` exactly the path's calls, the flight
   recorder's trace one span a boundary under the root; a
   ``torch.profiler`` trace in which each op's ``record_function`` range
   holds its kernels' launches (``convert_to_rows`` B6,
   ``convert_from_rows`` ``rows_to_planes``, ``hash_partition`` B1,
   ``inner_join`` B4); a seeded retryable rule on ``convert_from_rows`` at
   50% with retry armed (the path bit for bit, retries equal to the fires
   ``random.Random(seed)`` predicts), a fatal rule on ``convert_to_rows``
   (one attempt), and ``retry_with_split`` of ``convert_to_rows`` under a
   300 MiB budget (the splits predicted and counted in
   ``memory.split_retries``, the blob reassembled bit for bit). On the
   distributed path's mesh: ``exchange_by_key`` with metrics armed
   (``shuffle.bytes_exchanged`` the padded wire bytes; the retry
   contract's capacity doublings counted as the largest bucket
   predicts). Then the boundary's host cost a call (bare, wrapped and
   disarmed, wrapped and armed; median of 1,000), a ``hang`` rule on
   ``multiply128`` against ``deadline_s=0.2`` and a real out-of-memory in
   a wrapped op (``RetryableError``); the fixed and join paths' warm times
   with the boundary in place, the phase's and the script's wall seconds;
13. the EXCHANGE path, the cross-process TCP exchange
   (``parallel/shuffle.TcpExchange``, its worker harness and
   ``parallel/cluster.ClusterView``) at world 4 on the one card. (a) In
   this process: the join path's fact batch with an INT64 row id cut into
   4 row shards, each held by a loopback ``TcpExchange`` whose
   ``exchange_table(shard, ["item_sk"], peers)`` runs in its own thread,
   once under ``all_to_all`` and once under ``tree``; every rank's rows,
   their order, every column's bits and validity held against numpy plans
   (source rank order for the direct plan, a simulation of the hypercube
   rounds for the tree); wire bytes against the dense bytes moved, H2D
   copies, peak memory, first and warm ms, a profile, and one rank's
   encode / wire / decode split beside the host CRC's rate. (b) Across
   processes: ranks 1-3 started by ``spawn_exchange_fleet`` on the same
   card, this process rank 0, over the harness's demo table of 16,777,216
   rows (4,194,304 INT64 k, v rows a rank): 4 rounds without a cluster
   (the tree plan), 4 rounds with ``--cluster`` (the direct plan and
   heartbeats), and the chaos run with ci/chaos_cluster.json armed in the
   children (rank 2 killed on its first payload serve: exactly one death,
   generation 2, a recovery, rank 2's share rebuilt from lineage). Every
   run's group-by bit for bit the single-host one; worker start-up
   seconds apart from the rounds, steady-state round ms, the seconds from
   the kill to the confirmed death and to the answer. The counted run
   records every B1 call of this process ((a) and rank 0 in (b)), each
   held bit for bit against ``partition_map_plain``, their number the
   plans' prediction, and no other kernel launched; the phase's wall
   seconds;
14. the PLAN path, the plan tier (``plan/``: rewrites, statistics, the
   cost-based optimizer, ``compile_ir`` onto the fused pipeline and the
   operator tier) over ``models/tpcds_plans``, run after the distributed
   path: each generator's tables at the TPC-DS specification's SF1 fact
   cardinalities (store_sales 2,880,404 rows for ``gen_store_wide`` and
   ``gen_store``, catalog_sales 1,441,548, web_sales 719,384,
   store_returns 287,514; ``gen_channels`` at 2,880,404 store_sales rows,
   half as many web and catalog rows), made on the host and uploaded. The
   25 registry queries and ``q3_plan`` / ``q55_plan`` are compiled (the
   rewrite, the sketches, the CBO and the lowering timed apart) and run
   once on the card with the launch counts at 0; every B1, B4 and B3 call
   is recorded and held against its plain version (B1 and B4 bit for bit,
   B3's sums within its bound), and no other kernel may launch. Each
   result is held bit for bit against the port's CPU run of the same plan
   on the same tables copied to the CPU; ``q3_plan`` / ``q55_plan``
   against the hand-built ``models/tpcds.q3`` / ``q55``; q1
   (decorrelated), q38 (INTERSECT), q10 (EXISTS) and q9 (CASE over global
   aggregates) against numpy oracles, every float the nearest float64 of
   the exact rational; each inferred schema against the executed dtypes,
   each report's peak blowup at most 2.5. One ``ppart`` projection over
   store_sales puts B1 on the path at the fact's full size. Then each
   query's compile split, first-run and warm median-of-3 host ms, peak
   memory, fused against operator-tier stages, rewrites fired, launches
   and a profile; the phase's wall seconds;
15. the MEMGOV path, run after the plan path on tables and card results
   the earlier paths leave it (the tpch path's lineitem, the plan path's
   gen_store and gen_store_wide and its card ``q55_plan`` result, the
   join path's fact and dimension): (a) q55 with exchange stages at world
   4, ranks 1-3 ``--query q55`` worker processes on the same card over
   ``gen_store`` at SF1, the merged partials bit for bit the plan path's
   result; (b) out of core with the device budget at a quarter of the
   plan's estimate, TPC-H q1's IR over lineitem and a one-INT32-key
   aggregate over store_sales (B1 partitions it), each bit for bit its
   in-core run, with spills and no partition entry left; (c) the join
   path's dimension as a ``register_build`` table forced to host and to
   disk, every pipeline call bit for bit, with the D2H, H2D and frame
   rates; (d) the plan and subresult caches on a registry plan and its
   ``rebind_literals`` variant (miss, rebind hit, exact hit with
   subresult hits); (e) ``to_dmatrix(max_bins=256)`` over a 4,194,304-row
   table of Criteo's shape, cuts and bins bit for bit the CPU run's, with
   time and peak memory. Every B1, B4 and B3 call is held against its
   plain version; the phase's wall seconds;
16. prints one ``{"kernels": [...]}`` line (ten kernels) and, last, the
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
line, and exits 4. ``python3 chip_smoke.py --plan-only`` runs the plan
path alone (the kernels built, no other path): also a partial run, exit 4.
``python3 chip_smoke.py --memgov-only`` runs the memgov path alone, making
the inputs it would otherwise reuse: a partial run, exit 4.
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


# ---------------------------------------------------------------------------
# the distributed path: the in-mesh tier on an 8-shard mesh of one card
# ---------------------------------------------------------------------------

DIST_SHARDS = 8
DIST_ROWS = 1_048_576  # the group-by and sort batch (BASELINE.json configs[0])
DIST_SPLIT = 64  # the overflow contracts' capacity: a shard's rows / 64
# (query, star of the tpcds path): q7-q55 at SF1, q94 and q95 at SF10
DIST_QUERIES = (("q7", "wide1"), ("q19", "wide1"), ("q52", "store1"), ("q55", "store1"),
                ("q94", "web10"), ("q95", "web10"))
DIST_DEVICE = "cuda"  # "cpu" only to rehearse the phase without a card


def _np_murmur(lanes, seed: int = 42) -> np.ndarray:
    """Chained murmur3_32 of raw integer lanes in numpy uint32 (Spark
    Murmur3Hash chaining; a 4-byte lane is one block, an 8-byte lane its
    low then its high word): the port's routing hash before the pmod."""
    def rotl(x, r):
        return (x << np.uint32(r)) | (x >> np.uint32(32 - r))

    h = np.full(lanes[0].shape[0], seed, np.uint32)
    with np.errstate(over="ignore"):
        for lane in lanes:
            lane = np.ascontiguousarray(lane)
            words = ([lane.view(np.uint32)] if lane.itemsize == 4
                     else list(lane.view(np.uint32).reshape(-1, 2).T))
            for k in words:
                k = rotl(k * np.uint32(0xCC9E2D51), 15) * np.uint32(0x1B873593)
                h = rotl(h ^ k, 13) * np.uint32(5) + np.uint32(0xE6546B64)
            h = h ^ np.uint32(4 * len(words))
            h = (h ^ (h >> np.uint32(16))) * np.uint32(0x85EBCA6B)
            h = (h ^ (h >> np.uint32(13))) * np.uint32(0xC2B2AE35)
            h = h ^ (h >> np.uint32(16))
    return h


def _np_pmod(h: np.ndarray, p: int) -> np.ndarray:
    return np.mod(h.view(np.int32).astype(np.int64), p)


def _dist_inputs(seed: int, device):
    """The raw-array inputs: 1,048,576 INT64 keys uniform in [0, 4096) (the
    main path's domain) and INT64 values in [0, 1000); the sort's keys
    uniform over the full INT64 range and 90% one key; the join path's
    fact batch and item dimension (``_join_inputs``)."""
    import torch
    from spark_rapids_jni_tpu_torch.columnar import Table
    from spark_rapids_jni_tpu_torch.columnar import dtype as pdt
    from spark_rapids_jni_tpu_torch.interop import carry_table

    rng = np.random.default_rng(seed)
    h = {"keys": rng.integers(0, NUM_KEYS, DIST_ROWS).astype(np.int64),
         "vals": rng.integers(0, 1000, DIST_ROWS).astype(np.int64),
         "uniform": rng.integers(-2**63, 2**63 - 1, DIST_ROWS, dtype=np.int64)}
    h["skewed"] = np.where(rng.random(DIST_ROWS) < 0.9, 42,
                           rng.integers(-2**63, 2**63 - 1, DIST_ROWS, dtype=np.int64))
    h["k1"], h["k2"] = (h["keys"] % 64).astype(np.int32), (h["keys"] // 64).astype(np.int32)
    t = {k: torch.from_numpy(v).to(device) for k, v in h.items()}
    (fa, fv), (da, dv) = side = _join_inputs(seed + 1)
    fact = Table(carry_table(fa, [_pdtype(pdt, tn) for _, tn in FACT_COLS], fv,
                             device=device).columns, [n for n, _ in FACT_COLS])
    dim = Table(carry_table(da, [_pdtype(pdt, tn) for _, tn in DIM_COLS], dv,
                            device=device).columns, [n for n, _ in DIM_COLS])
    # the join's left side: the fact's non-null item_sk rows, cut to a
    # multiple of the shards (the raw-array join takes N / P rows a shard)
    live = np.flatnonzero(fv[1])
    live = live[:live.shape[0] // DIST_SHARDS * DIST_SHARDS]
    h["lk"], h["lv"] = fa[1][live], fa[8][live]  # item_sk, ss_ticket_number
    h["rk"], h["rv"] = da[0], da[1]  # item_sk, i_brand_id
    for k in ("lk", "lv", "rk", "rv"):
        t[k] = torch.from_numpy(np.ascontiguousarray(h[k])).to(device)
    return h, t, side, fact, dim


def _dist_ops(t, fact, dim, stars, mesh, one_a_card):
    """The path's operations, each a callable: the raw-array group-bys
    (8 shards, and the default mesh of one shard a card), the exchange of
    the fact batch (default capacity, then the three overflow contracts at
    a shard's rows / 64), the Table-tier exchange of the dimension, the
    raw join, the sample sorts and the six TPC-DS queries."""
    from spark_rapids_jni_tpu_torch.models import tpcds
    from spark_rapids_jni_tpu_torch.parallel import (distributed, join_distributed, mesh as pmesh,
                                                     shuffle, sort_distributed, table_ops)
    from spark_rapids_jni_tpu_torch.utils.errors import RetryableError

    fact_s = pmesh.shard_table_rows(fact, mesh)
    cap = DIST_ROWS // DIST_SHARDS // DIST_SPLIT

    def overflow_raises():
        try:
            shuffle.exchange_by_key(fact_s, ["item_sk"], mesh, capacity=cap)
        except RetryableError as e:
            return e
        raise AssertionError("an exchange past its capacity did not raise RetryableError")

    ops = {
        "groupby_sum": lambda: distributed.distributed_groupby_sum(t["keys"], t["vals"], mesh),
        "groupby_sum_multi": lambda: distributed.distributed_groupby_sum_multi(
            [t["k1"], t["k2"]], t["vals"], mesh),
        "groupby_sum_one_shard_a_card": lambda: distributed.distributed_groupby_sum(
            t["keys"], t["vals"], one_a_card),
        "exchange_by_key": lambda: shuffle.exchange_by_key(fact_s, ["item_sk"], mesh),
        "exchange_overflow_raise": overflow_raises,
        "exchange_overflow_flag": lambda: shuffle.exchange_by_key(
            fact_s, ["item_sk"], mesh, capacity=cap, on_overflow="flag"),
        "exchange_overflow_retry": lambda: shuffle.exchange_by_key(
            fact_s, ["item_sk"], mesh, capacity=cap, on_overflow="retry"),
        "exchange_table": lambda: table_ops.exchange_table(dim, ["i_brand_id"], mesh),
        "inner_join": lambda: join_distributed.distributed_inner_join(
            t["lk"], t["lv"], t["rk"], t["rv"], mesh),
    }
    for keys in ("uniform", "skewed"):
        for desc in (False, True):
            ops[f"sort_{keys}" + ("_desc" if desc else "")] = (
                lambda k=keys, d=desc: sort_distributed.distributed_sort(t[k], mesh, descending=d))
    for q, star in DIST_QUERIES:
        ops[f"{q}_distributed"] = lambda q=q, s=star: getattr(tpcds, f"{q}_distributed")(
            stars[s], mesh)
    return ops


def _dist_capture(ops):
    """Run every operation once, timed by the host clock to a synchronize,
    with recorders in the routing and in front of B1's wrapper: each call of
    ``distributed._hash_dest_multi`` and ``shuffle.hash_partition_map``
    that the routing rule sends to B1 (one INT32 or INT64 lane, or one such
    column at the default seed) adds one to the prediction, and every B1
    call is held bit for bit against ``partition_map_plain`` after its
    operation, outside the timing. Returns (results, first-run ms by
    operation, B1 calls by operation, predicted by operation)."""
    import torch
    from spark_rapids_jni_tpu_torch.columnar.dtype import TypeId
    from spark_rapids_jni_tpu_torch.ops import hashing
    from spark_rapids_jni_tpu_torch.ops import hopper_kernels as hk
    from spark_rapids_jni_tpu_torch.parallel import distributed, shuffle

    route, hpm, b1_d, b1_h = (distributed._hash_dest_multi, shuffle.hash_partition_map,
                              distributed.partition_map, hashing.partition_map)
    seen, predicted = [], [0]

    def route_rec(key_arrays, n_parts):
        key_arrays = list(key_arrays)
        predicted[0] += (len(key_arrays) == 1 and key_arrays[0].shape[0] > 0
                         and key_arrays[0].dtype in (torch.int32, torch.int64))
        return route(key_arrays, n_parts)

    def hpm_rec(cols, num_partitions, seed=42):
        cols = list(cols)
        predicted[0] += (len(cols) == 1 and seed == 42 and len(cols[0]) > 0
                         and cols[0].dtype.id in (TypeId.INT32, TypeId.INT64))
        return hpm(cols, num_partitions, seed)

    def b1_rec(keys, num_partitions, valid=None):
        out = hk.partition_map(keys, num_partitions, valid)
        if keys.shape[0]:  # an empty call launches nothing
            seen.append((keys, num_partitions, valid, out))
        return out

    out, stage, calls, pred = {}, {}, {}, {}
    distributed._hash_dest_multi, shuffle.hash_partition_map = route_rec, hpm_rec
    distributed.partition_map = hashing.partition_map = b1_rec
    try:
        for name, op in ops.items():
            seen.clear()
            predicted[0] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[name] = op()
            torch.cuda.synchronize()
            stage[f"{name}_ms"] = (time.perf_counter() - t0) * 1e3
            for keys, p, valid, got in seen:
                if not torch.equal(got, hk.partition_map_plain(keys, p, valid)):
                    raise AssertionError(f"distributed {name}: B1 differs from its plain version "
                                         f"on [{keys.shape[0]}] {keys.dtype} keys")
            calls[name], pred[name] = len(seen), predicted[0]
    finally:
        distributed._hash_dest_multi, shuffle.hash_partition_map = route, hpm
        distributed.partition_map, hashing.partition_map = b1_d, b1_h
    seen.clear()
    stage["end_to_end_ms"] = sum(stage.values())
    return out, stage, calls, pred


def _expect_groups(key_lanes, vals: np.ndarray, p: int):
    """The distributed group-by's exact output: the unique key tuples in
    shard order (by the routing hash), by key within a shard, their int64
    sums, and each group's shard."""
    stacked = np.stack([k.astype(np.int64) for k in key_lanes], axis=1)
    uniq, inv = np.unique(stacked, axis=0, return_inverse=True)
    sums = np.bincount(inv.reshape(-1), weights=vals, minlength=len(uniq)).astype(np.int64)
    dest = _np_pmod(_np_murmur([uniq[:, j].astype(k.dtype) for j, k in enumerate(key_lanes)]), p)
    order = np.argsort(dest, kind="stable")
    return [uniq[order, j] for j in range(len(key_lanes))], sums[order], dest[order]


def _check_dist_groupby(h, out, p_one: int) -> dict:
    """Both group-bys against numpy: keys, their order (shard by shard) and
    placement, and sums exact, no overflow."""
    res = {}
    for name, lanes, p in (("groupby_sum", [h["keys"]], DIST_SHARDS),
                           ("groupby_sum_multi", [h["k1"], h["k2"]], DIST_SHARDS),
                           ("groupby_sum_one_shard_a_card", [h["keys"]], p_one)):
        got = out[name]
        gkeys, gsums, ovf = ([got[0]], got[1], got[2]) if len(lanes) == 1 else got
        if ovf:
            raise AssertionError(f"distributed {name} overflowed")
        wkeys, wsums, dest = _expect_groups(lanes, h["vals"], p)
        for g, w in zip(gkeys, wkeys):
            if not np.array_equal(np.asarray(g).astype(np.int64), w):
                raise AssertionError(f"distributed {name}: group keys or their shard order differ")
        if not np.array_equal(gsums, wsums):
            raise AssertionError(f"distributed {name}: sums differ from numpy")
        res[name] = {"groups": int(len(wsums)),
                     "groups_by_shard": np.bincount(dest, minlength=p).tolist()}
    return res


def _check_exchange(fa, fv, pairs, mask, dest: np.ndarray, what: str) -> list:
    """An exchange of the fact batch: the received rows of shard d are the
    rows whose oracle destination is d, in row order, bit for bit with
    their validity; returns the rows each shard received."""
    m = mask.reshape(-1).cpu().numpy()
    order = np.argsort(dest, kind="stable")
    by_shard = mask.reshape(DIST_SHARDS, -1).sum(1).cpu().numpy().tolist()
    if by_shard != np.bincount(dest, minlength=DIST_SHARDS).tolist():
        raise AssertionError(f"{what}: rows by shard {by_shard} differ from the oracle's")
    for (name, _), a, v, (data, valid) in zip(FACT_COLS, fa, fv, pairs):
        got = data.reshape((m.shape[0],) + tuple(data.shape[2:])).cpu().numpy()[m]
        if not np.array_equal(got.view(np.uint8), np.ascontiguousarray(a[order]).view(np.uint8)):
            raise AssertionError(f"{what}: column {name} differs from the oracle's rows")
        if (valid is None) != (v is None) or (
                v is not None and not np.array_equal(valid.reshape(-1).cpu().numpy()[m], v[order])):
            raise AssertionError(f"{what}: the validity of {name} differs from the oracle's")
    return by_shard


def _same_result(got, want, what: str) -> None:
    """A distributed query's result bit for bit against the single-chip one:
    names, types, data bits and null masks, or q94/q95's count and float
    bits."""
    import torch

    if isinstance(want, dict):
        if got["order_count"] != want["order_count"] or any(
                np.float64(got[k]).view(np.uint64) != np.float64(want[k]).view(np.uint64)
                for k in ("total_shipping_cost", "total_net_profit")):
            raise AssertionError(f"{what}: {got} differs from the single chip's {want}")
        return
    if got.names != want.names or got.num_rows != want.num_rows:
        raise AssertionError(f"{what}: {got.names} x {got.num_rows} differs from the single "
                             f"chip's {want.names} x {want.num_rows}")
    for name, g, w in zip(want.names, got.columns, want.columns):
        if g.dtype != w.dtype or not torch.equal(g.data, w.data) or not torch.equal(
                g.valid_mask(), w.valid_mask()):
            raise AssertionError(f"{what}: column {name} differs from the single chip's")


def _check_dist(h, t, side, dim, stars, out, p_one: int) -> dict:
    """Every operation's result against its oracle."""
    import torch
    from spark_rapids_jni_tpu_torch.models import tpcds
    from spark_rapids_jni_tpu_torch.utils.errors import RetryableError

    (fa, fv), (da, dv) = side
    res = _check_dist_groupby(h, out, p_one)
    dest = _np_partition(fa[1], fv[1], DIST_SHARDS)
    pairs, mask, ovf = out["exchange_by_key"]
    if bool(ovf.any()):
        raise AssertionError("the exchange at its default capacity overflowed")
    res["exchange_rows_by_shard"] = _check_exchange(fa, fv, pairs, mask, dest, "exchange_by_key")
    if not isinstance(out["exchange_overflow_raise"], RetryableError):
        raise AssertionError("the raise contract did not raise RetryableError")
    pairs, mask, ovf = out["exchange_overflow_flag"]
    if not bool(ovf.any()) or int(mask.sum()) >= DIST_ROWS:
        raise AssertionError("the flag contract did not flag its dropped rows")
    res["flag_rows_kept"] = int(mask.sum())
    pairs, mask, ovf = out["exchange_overflow_retry"]
    if bool(ovf.any()):
        raise AssertionError("the retry contract left an overflow")
    _check_exchange(fa, fv, pairs, mask, dest, "exchange_overflow_retry")
    res["retry_capacity"] = int(mask.shape[-1])

    # the dimension's exchange on i_brand_id: the rows of shard d in row
    # order, every string byte for byte
    table, ovf = out["exchange_table"]
    if ovf:
        raise AssertionError("exchange_table overflowed")
    order = np.argsort(_np_pmod(_np_murmur([da[1]]), DIST_SHARDS), kind="stable")
    if sorted(order.tolist()) != list(range(DIM_ROWS)) or table.num_rows != DIM_ROWS:
        raise AssertionError("exchange_table did not return a permutation of the rows")
    for (name, _), col, a, v in zip(DIM_COLS, table.columns, da, dv):
        data, valid = _np_gather(a, v, order)
        if isinstance(data, tuple):
            ok = (np.array_equal(col.offsets.cpu().numpy(), data[0])
                  and np.array_equal(col.chars.cpu().numpy(), data[1]))
        else:
            ok = np.array_equal(col.to_numpy(), data)
        if not ok or not np.array_equal(col.valid_mask().cpu().numpy(), valid):
            raise AssertionError(f"exchange_table: column {name} differs from the oracle's rows")

    k, lv, rv, ovf = out["inner_join"]
    lmap, rmap = _np_join_maps(h["lk"], np.ones(h["lk"].shape[0], bool), h["rk"], None, "inner")
    want = np.stack([h["lk"][lmap].astype(np.int64), h["lv"][lmap], h["rv"][rmap]])
    got = np.stack([k.astype(np.int64), lv, rv.astype(np.int64)])
    if ovf or not np.array_equal(got[:, np.lexsort(got[::-1])], want[:, np.lexsort(want[::-1])]):
        raise AssertionError("inner_join's (key, left, right) multiset differs from numpy's")
    res["join_rows"] = int(lmap.shape[0])

    for keys in ("uniform", "skewed"):
        for desc in (False, True):
            name = f"sort_{keys}" + ("_desc" if desc else "")
            s, ovf = out[name]
            want = np.sort(h[keys])
            if ovf or not np.array_equal(s, want[::-1] if desc else want):
                raise AssertionError(f"{name} differs from np.sort")

    rows = {}
    for q, star in DIST_QUERIES:
        want = getattr(tpcds, q)(stars[star])
        _same_result(out[f"{q}_distributed"], want, f"{q}_distributed")
        rows[q] = want["order_count"] if isinstance(want, dict) else want.num_rows
        if not rows[q]:
            raise AssertionError(f"{q} selected nothing")
    res["query_rows"] = rows
    return res


def _dist_corruption(fact, mesh) -> None:
    """One flipped value in a received bucket of the fact's exchange must
    raise DataCorruption."""
    from spark_rapids_jni_tpu_torch.parallel import mesh as pmesh
    from spark_rapids_jni_tpu_torch.parallel import shuffle
    from spark_rapids_jni_tpu_torch.utils.errors import DataCorruption

    real = pmesh.all_to_all
    first = [True]

    def flip_one(parts):
        out = real(parts)
        if first[0]:  # the first lane: an occupied slot's low bit
            out[3][2, 0] ^= 1
            first[0] = False
        return out

    pmesh.all_to_all = flip_one
    try:
        shuffle.exchange_by_key(pmesh.shard_table_rows(fact, mesh), ["item_sk"], mesh)
    except DataCorruption as e:
        print(f"distributed: a flipped value in a received bucket raised DataCorruption ({e})",
              flush=True)
        return
    finally:
        pmesh.all_to_all = real
    raise AssertionError("a flipped value in a received bucket passed the exchange's check")


def _wire_bytes(h, fact, dim) -> dict:
    """Each exchange's padded wire bytes (P x P x capacity x row bytes, the
    reference's cost model: every lane's bytes a row and the mask's byte)
    against its dense bytes (rows x row bytes), at the capacity each ran."""
    from spark_rapids_jni_tpu_torch.parallel.table_ops import default_capacity

    p, per = DIST_SHARDS, DIST_ROWS // DIST_SHARDS
    fact_row = sum(c.data[:1].numel() * c.data.element_size() + (c.validity is not None)
                   for c in fact.columns) + 1
    dim_row = 4 * (len(DIM_COLS) + 1) + 1  # INT32 lanes and codes, the present lane
    nl, nr = h["lk"].shape[0], h["rk"].shape[0]
    jcap = max(nl, nr) // p
    cases = {  # name: (rows, row bytes, capacity, exchanges)
        "groupby_sum": (DIST_ROWS, 8 + 8 + 1, per, 1),
        "groupby_sum_multi": (DIST_ROWS, 4 + 4 + 8 + 1, per, 1),
        "exchange_by_key": (DIST_ROWS, fact_row, per, 1),
        "exchange_table": (DIM_ROWS, dim_row, default_capacity(DIM_ROWS // p, p), 1),
        "inner_join_left": (nl, 4 + 8 + 1, jcap, 1),
        "inner_join_right": (nr, 4 + 4 + 1, jcap, 1),
        "sort": (DIST_ROWS, 8 + 1, per, 1),
    }
    return {k: {"wire_bytes": p * p * cap * rb * ex, "dense_bytes": n * rb, "capacity": cap}
            for k, (n, rb, cap, ex) in cases.items()}


def _dist_phase(wrappers, stars) -> tuple:
    """The distributed path: inputs, the counted run with every B1 call
    recorded and held against its plain version, every check, the
    corruption check, then each operation warm and profiled. Returns
    (paths entry, launches)."""
    import torch
    from spark_rapids_jni_tpu_torch.ops import hopper_kernels as hk
    from spark_rapids_jni_tpu_torch.parallel import mesh as pmesh

    t_phase = time.perf_counter()
    dev = torch.device(DIST_DEVICE, 0) if DIST_DEVICE == "cuda" else torch.device(DIST_DEVICE)
    mesh = pmesh.make_mesh({"data": DIST_SHARDS}, devices=[dev] * DIST_SHARDS)
    # the default mesh: one shard a card (on the CPU rehearsal, one shard)
    one_a_card = pmesh.make_mesh() if DIST_DEVICE == "cuda" else pmesh.make_mesh(devices=[dev])
    p_one = one_a_card.shape["data"]
    h, t, side, fact, dim = _dist_inputs(SEED + 13, dev)
    torch.cuda.synchronize()
    print(f"distributed input: mesh {mesh} and the default {one_a_card}; {DIST_ROWS} INT64 keys in "
          f"[0, {NUM_KEYS}) with INT64 values, {DIST_ROWS} sort keys twice (uniform, 90% one "
          f"key), the fact batch {FACT_ROWS} x {len(FACT_COLS)} and the dimension {DIM_ROWS} x "
          f"{len(DIM_COLS)}, join sides {h['lk'].shape[0]} / {h['rk'].shape[0]}; TPC-DS stars "
          f"of the tpcds path; made and uploaded in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    ops = _dist_ops(t, fact, dim, stars, mesh, one_a_card)
    (out, stage, calls, pred), launches = _run_counted(wrappers, lambda: _dist_capture(ops))
    print(f"distributed path launches: {launches}; B1 calls by operation {calls}, predicted by "
          f"the routing rule {pred}", flush=True)
    if calls != pred:
        raise AssertionError(f"distributed: B1 calls {calls} differ from the routing rule's {pred}")
    total = sum(calls.values())
    others = {k: v for k, v in launches.items() if k != "partition_map" and v}
    if others:
        raise AssertionError(f"the distributed path launched kernels it does not run: {others}")
    if DIST_DEVICE == "cuda" and launches["partition_map"] != total:
        raise AssertionError(f"the distributed path launched B1 {launches['partition_map']} "
                             f"times, {total} calls recorded")
    t0 = time.perf_counter()
    check = _check_dist(h, t, side, dim, stars, out, p_one)
    print(f"distributed path checked in {time.perf_counter() - t0:.1f} s: group-bys, placement "
          f"and sums exact against numpy; every fact row on its shard, in row order, bit for bit "
          f"with validity (default capacity and the retry contract); raise and flag contracts; "
          f"the dimension's exchange a permutation, strings byte for byte; the join's multiset and "
          f"both sorts exact; the six TPC-DS queries bit-identical to single-chip; all {total} B1 "
          f"calls bit for bit their plain version: {check}", flush=True)
    ex_default = out["exchange_by_key"]
    del out
    _dist_corruption(fact, mesh)
    wire = _wire_bytes(h, fact, dim)
    for k, w in wire.items():
        print(f"distributed {k} exchange: capacity {w['capacity']}, padded wire "
              f"{w['wire_bytes']} B against dense {w['dense_bytes']} B "
              f"({w['wire_bytes'] / w['dense_bytes']:.1f}x)", flush=True)
    # the runtime path's exchange check (d), on this mesh and batch
    runtime_ex = _runtime_exchange(pmesh.shard_table_rows(fact, mesh), mesh, ex_default, wire)
    del ex_default
    warm_ops = {k: v for k, v in ops.items() if k != "exchange_overflow_raise"}
    warm, peak, profiles = _warm_and_profile("distributed", warm_ops, stage,
                                             {"partition_map_kernel": hk.partition_map})
    wall = time.perf_counter() - t_phase
    print(f"distributed phase: {wall:.1f} s wall (input, counted run, checks, warm runs, "
          f"profiles)", flush=True)
    return ({**stage, "warm": warm, "warm_end_to_end_ms": warm["end_to_end_ms"], **check,
             "shards": DIST_SHARDS, "rows": DIST_ROWS, "b1_calls": calls, "wire": wire,
             "runtime_exchange": runtime_ex,
             "peak_gib": peak, "phase_wall_s": wall, "launches": launches,
             "profile": profiles}, launches)


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


# ---------------------------------------------------------------------------
# the runtime path: the op boundary around the paths (knobs, metrics,
# tracing, deadlines, retry, fault injection)
# ---------------------------------------------------------------------------

RUNTIME_CALLS = 1000  # calls a boundary-cost case is timed over (median)
RUNTIME_FAULT_PERCENT = 50.0  # the seeded retryable rule on convert_from_rows
RUNTIME_RETRY = dict(max_attempts=4, base_delay_ms=1.0, seed=SEED)
RUNTIME_SPLIT_BUDGET = 300 << 20  # below the fixed batch's 792,000,000 B of rows
HANG_DEADLINE_S = 0.2
HANG_SLACK_S = 0.1  # the hang polls its deadline every 50 ms at most, and wakes 5 ms past it


def _kernels_in_range(prof, range_name: str) -> list:
    """Device kernels launched inside the ``record_function`` range(s)
    named ``range_name`` of a finished ``torch.profiler`` session: those
    whose runtime launch call (``cudaLaunch*`` / ``cuLaunch*``, matched by
    its correlation id) starts within the range on the host."""
    from torch.autograd import DeviceType

    ev = prof.profiler.kineto_results.events()
    ranges = [(e.start_ns(), e.end_ns()) for e in ev
              if e.name() == range_name and e.device_type() == DeviceType.CPU]
    corr = {e.correlation_id() for e in ev
            if e.device_type() == DeviceType.CPU and e.name().startswith(("cudaLaunch", "cuLaunch"))
            and any(s <= e.start_ns() <= t for s, t in ranges)}
    return [e.name() for e in ev
            if e.device_type() == DeviceType.CUDA and e.correlation_id() in corr]


def _ranges_enclose(run, expect) -> dict:
    """``run`` once under ``torch.profiler`` (host and device) with tracing
    armed; every op range in ``expect`` must enclose the launch of a
    kernel named like its value. A trace that misses one is taken again,
    twice at most. Returns the kernels found under each range."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from spark_rapids_jni_tpu_torch.utils import tracing

    run()
    torch.cuda.synchronize()
    for attempt in range(1, 4):
        with tracing.enabled():
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                run()
                torch.cuda.synchronize()
        found = {op: sorted({n[:60] for n in _kernels_in_range(prof, op)}) for op in expect}
        missing = {op: k for op, k in expect.items() if not any(k in n for n in found[op])}
        if not missing:
            return {"ranges": found, "traces": attempt}
        print(f"runtime: trace {attempt} shows no {missing} under the op ranges", flush=True)
    raise AssertionError(f"the profiler shows no kernel {missing} inside the op ranges: {found}")


def _armed_run(label: str, run, ops: dict) -> tuple:
    """(b) ``run`` once with metrics and tracing armed, inside one root
    trace ``path.<label>``: ``op.<name>.calls`` must be exactly ``ops``, and
    the flight recorder's trace must hold one span a boundary crossed,
    each a child of the root. Returns (run's result, summary)."""
    from spark_rapids_jni_tpu_torch.utils import metrics, trace_sink, tracing

    metrics.reset()
    trace_sink.reset_for_tests()
    t0 = time.perf_counter()
    with metrics.enabled(), tracing.enabled():
        qt = tracing.start_trace(f"path.{label}")
        with qt.activate():
            out = run()
        qt.finish()
    wall_ms = (time.perf_counter() - t0) * 1e3
    calls = {k[3:-6]: v for k, v in metrics.counters_snapshot().items()
             if k.startswith("op.") and k.endswith(".calls") and v}
    if calls != ops:
        raise AssertionError(f"runtime {label}: op calls {calls}, the path makes {ops}")
    rec = trace_sink.recorder().last(1)[0]
    roots = [s for s in rec["spans"] if s["parent"] is None]
    op_spans = [s for s in rec["spans"] if s["name"].startswith("op.")]
    if (len(roots) != 1 or roots[0]["name"] != f"path.{label}" or rec["status"] != "ok"
            or sorted(s["name"][3:] for s in op_spans) != sorted(
                n for n, c in ops.items() for _ in range(c))
            or any(s["parent"] != roots[0]["span"] for s in op_spans)):
        raise AssertionError(f"runtime {label}: the flight recorder's trace is not one span a "
                             f"boundary under the root: {trace_sink.render_trace(rec)}")
    print(f"runtime {label}, armed (metrics and tracing): op calls {calls}; "
          f"{wall_ms:.2f} ms host; flight recorder:\n{trace_sink.render_trace(rec)}", flush=True)
    out_stats = {"op_calls": calls, "spans": len(op_spans), "armed_ms": wall_ms,
                 "dispatch_tiers": {k: v for k, v in metrics.counters_snapshot().items()
                                    if k.startswith("dispatch.tier.") and v}}
    metrics.reset()
    return out, out_stats


def _same_sums(got, want, what: str) -> bool:
    """Float32 sums against the disarmed run's: bit for bit expected; B3
    adds float64 atomics in no fixed order, so the path's tolerance holds
    them and whether they were bit-identical is reported."""
    import torch

    same = torch.equal(got, want)
    if not same and not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
        raise AssertionError(f"runtime {what}: sums outside the path's tolerance of the "
                             "disarmed run")
    return same


def _predicted_fires(seed: int, attempts: int) -> int:
    """Fires of a rule at ``RUNTIME_FAULT_PERCENT`` over one op's retried
    attempts: the injector's draws, ``random.Random(seed).uniform(0,
    100) < percent``, until one does not fire."""
    import random

    rng = random.Random(seed)
    fires = 0
    while fires < attempts and rng.uniform(0, 100) < RUNTIME_FAULT_PERCENT:
        fires += 1
    return fires


def _split_plan(rows: int, row_bytes: int, budget: int, depth: int) -> tuple:
    """(splits, batches) of retry_with_split over a batch that fails while
    its rows' bytes exceed ``budget``."""
    if rows * row_bytes <= budget or depth == 0 or rows < 2:
        return 0, 1
    a = _split_plan(rows // 2, row_bytes, budget, depth - 1)
    b = _split_plan(rows - rows // 2, row_bytes, budget, depth - 1)
    return 1 + a[0] + b[0], a[1] + b[1]


def _runtime_fixed(wrappers, table, dtypes, layout, rows, dec, sums, counts) -> tuple:
    """The runtime path on the fixed path's table: (b) the armed run, bit
    for bit the disarmed one, and the op ranges around B6 and
    rows_to_planes; (c) a seeded retryable fault on convert_from_rows
    with retry armed, a fatal one on convert_to_rows, and retry_with_split
    of convert_to_rows under a budget below the batch. Returns (summary,
    launches of the armed run)."""
    import torch
    from spark_rapids_jni_tpu_torch.ops import row_conversion as rc
    from spark_rapids_jni_tpu_torch.utils import faultinj, memory, metrics, retry
    from spark_rapids_jni_tpu_torch.utils.errors import FatalDeviceError

    run = lambda: _main_path(table, dtypes, key=0, value=1)  # noqa: E731
    (arm, stats), launches = _run_counted(
        wrappers, lambda: _armed_run("fixed", run, {"convert_to_rows": 1, "convert_from_rows": 1}))
    for k in FIXED_PATH_KERNELS:
        if launches[k] < 1:
            raise AssertionError(f"runtime fixed: the armed run never launched {k}")
    if not (torch.equal(arm[0][0].child.data, rows[0].child.data)
            and _same_columns(arm[1], dec) and torch.equal(arm[3], counts)):
        raise AssertionError("runtime fixed: the armed run differs from the disarmed run")
    stats["sums_bit_identical"] = _same_sums(arm[2], sums, "fixed")
    del arm
    stats["profiler"] = _ranges_enclose(
        lambda: rc.convert_from_rows(rc.convert_to_rows(table)[0], dtypes),
        {"convert_to_rows": "expand", "convert_from_rows": "rows_to_planes"})
    print(f"runtime fixed: op ranges enclose their kernels: {stats['profiler']}", flush=True)

    # (c) a seeded retryable fault with retry armed: the path finishes bit
    # for bit, and retries equal the fires random.Random(seed) predicts
    seed = next(s for s in range(SEED, SEED + 1000)
                if 1 <= _predicted_fires(s, RUNTIME_RETRY["max_attempts"])
                < RUNTIME_RETRY["max_attempts"])
    predicted = _predicted_fires(seed, RUNTIME_RETRY["max_attempts"])
    retry.reset_stats()
    metrics.reset()
    faultinj.configure({"seed": seed, "faults": {
        "convert_from_rows": {"type": "retryable", "percent": RUNTIME_FAULT_PERCENT}}})
    try:
        t0 = time.perf_counter()
        with retry.enabled(**RUNTIME_RETRY), metrics.enabled():
            chaos = run()
        chaos_ms = (time.perf_counter() - t0) * 1e3
    finally:
        faultinj.disable()
    st = retry.stats()
    fired = metrics.registry().value("retry.retries.RetryableError")
    if not (st["retries"] == fired == predicted and st["exhausted"] == 0):
        raise AssertionError(f"runtime fixed: {st['retries']} retries, {fired} counted fires, "
                             f"{predicted} predicted by random.Random({seed})")
    if not (torch.equal(chaos[0][0].child.data, rows[0].child.data)
            and _same_columns(chaos[1], dec) and torch.equal(chaos[3], counts)):
        raise AssertionError("runtime fixed: the path under a retried fault differs")
    del chaos
    stats["retryable"] = {"seed": seed, "fires": fired, "predicted": predicted, "ms": chaos_ms,
                          "retry": st}
    print(f"runtime fixed: retryable rule on convert_from_rows at {RUNTIME_FAULT_PERCENT:g}% "
          f"(seed {seed}) fired {fired} times, {predicted} predicted by random.Random(seed); "
          f"retry stats {st}; the path finished bit for bit in {chaos_ms:.2f} ms", flush=True)

    # a fatal fault is attempted once, retry armed or not
    retry.reset_stats()
    faultinj.configure({"seed": seed, "faults": {"convert_to_rows": {"type": "fatal"}}})
    try:
        with retry.enabled(**RUNTIME_RETRY):
            rc.convert_to_rows(table)
        raise AssertionError("runtime fixed: a fatal rule did not raise")
    except FatalDeviceError as e:
        st = retry.stats()
        if st["attempts"] != 1 or st["fatal"] != 1 or st["retries"] != 0:
            raise AssertionError(f"runtime fixed: a fatal fault was retried: {st}")
        print(f"runtime fixed: fatal rule on convert_to_rows raised FatalDeviceError ({e}) after "
              f"{st['attempts']} attempt", flush=True)
    finally:
        faultinj.disable()
    stats["fatal_attempts"] = 1

    # retry_with_split under a budget below the batch: split and
    # reassembled bit for bit; each budget-forced split counts in
    # memory.split_retries, as the Table tier's split does
    plan = _split_plan(ROWS, layout.row_size_fixed, RUNTIME_SPLIT_BUDGET,
                       retry.RetryPolicy().split_depth)

    def fits(b):
        if b.num_rows * layout.row_size_fixed > memory.device_memory_budget(b.columns[0].device):
            raise memory.MemoryBudgetExceeded(
                f"{b.num_rows} rows of {layout.row_size_fixed} B over the budget")
        return rc.convert_to_rows(b)

    def split(b):
        memory._note_split()
        return retry._default_split(b)

    retry.reset_stats()
    before = memory.split_retry_count()
    t0 = time.perf_counter()
    with memory.budget(RUNTIME_SPLIT_BUDGET):
        parts = retry.retry_with_split(fits, table, split=split, op_name="convert_to_rows",
                                       combine=lambda ps: [c for p in ps for c in p],
                                       policy=retry.RetryPolicy(base_delay_ms=0.0, seed=SEED))
    torch.cuda.synchronize()
    split_ms = (time.perf_counter() - t0) * 1e3
    nsplit = memory.split_retry_count() - before
    blob = torch.cat([p.child.data for p in parts])
    if not (nsplit == retry.stats()["splits"] == plan[0] and len(parts) == plan[1]
            and sum(len(p) for p in parts) == ROWS and torch.equal(blob, rows[0].child.data)):
        raise AssertionError(f"runtime fixed: retry_with_split made {nsplit} splits and "
                             f"{len(parts)} batches, {plan} predicted, or its rows differ")
    del parts, blob
    stats["split"] = {"budget": RUNTIME_SPLIT_BUDGET, "splits": nsplit, "batches": plan[1],
                      "ms": split_ms}
    print(f"runtime fixed: retry_with_split(convert_to_rows) under a {RUNTIME_SPLIT_BUDGET} B "
          f"budget made {nsplit} splits (memory.split_retries, as predicted) into {plan[1]} "
          f"batches, reassembled bit for bit, in {split_ms:.2f} ms", flush=True)
    return stats, launches


def _runtime_join(wrappers, fact, dim, part, offsets, joined, sums, counts) -> tuple:
    """The runtime path on the join path's tables: (b) the armed run, bit
    for bit the disarmed one, and the op ranges around B1 and B4. Returns
    (summary, launches of the armed run)."""
    import torch
    from spark_rapids_jni_tpu_torch.ops import join
    from spark_rapids_jni_tpu_torch.parallel import shuffle

    (arm, stats), launches = _run_counted(
        wrappers, lambda: _armed_run("join", lambda: _join_path(fact, dim),
                                     {"hash_partition": 1, "inner_join": 1}))
    for k in JOIN_PATH_KERNELS:
        if launches[k] < 1:
            raise AssertionError(f"runtime join: the armed run never launched {k}")
    if not (_same_columns(arm[0], part) and arm[1] == offsets and _same_columns(arm[2], joined)
            and torch.equal(arm[4], counts)):
        raise AssertionError("runtime join: the armed run differs from the disarmed run")
    stats["sums_bit_identical"] = _same_sums(arm[3], sums, "join")
    del arm
    stats["profiler"] = _ranges_enclose(
        lambda: join.inner_join(shuffle.hash_partition(fact, PARTITIONS, ["item_sk"])[0], dim,
                                ["item_sk"]),
        {"hash_partition": "partition_map", "inner_join": "probe"})
    print(f"runtime join: op ranges enclose their kernels: {stats['profiler']}", flush=True)
    return stats, launches


def _runtime_exchange(fact_s, mesh, default_out, wire: dict) -> dict:
    """(d) ``exchange_by_key`` of the fact batch on the 8-shard mesh with
    metrics armed: ``shuffle.bytes_exchanged`` must equal the padded wire
    bytes the path prints; then the retry contract at a shard's rows / 64,
    whose capacity doublings must be counted as predicted from the
    largest bucket of the default-capacity exchange."""
    from spark_rapids_jni_tpu_torch.parallel import shuffle
    from spark_rapids_jni_tpu_torch.utils import metrics, retry

    metrics.reset()
    with metrics.enabled():
        shuffle.exchange_by_key(fact_s, ["item_sk"], mesh)
    got = metrics.registry().value("shuffle.bytes_exchanged")
    want = wire["exchange_by_key"]["wire_bytes"]
    if got != want or metrics.registry().value("shuffle.exchanges") != 1:
        raise AssertionError(f"runtime exchange: shuffle.bytes_exchanged {got} != wire {want}")
    per = DIST_ROWS // DIST_SHARDS
    cap = cap0 = per // DIST_SPLIT
    biggest = int(default_out[1].sum(1).max())  # the fullest (source, destination) bucket
    caps = [cap]
    while cap < biggest and cap < per:
        cap = min(2 * cap, per)
        caps.append(cap)
    row_bytes = want // (DIST_SHARDS * DIST_SHARDS * per)
    metrics.reset()
    retry.reset_stats()
    with metrics.enabled():
        shuffle.exchange_by_key(fact_s, ["item_sk"], mesh, capacity=cap0, on_overflow="retry")
    reg = metrics.registry()
    out = {"bytes_exchanged": got, "wire_bytes": want, "retry_capacities": caps,
           "capacity_retries": reg.value("shuffle.capacity_retries"),
           "retry_bytes": reg.value("shuffle.bytes_exchanged")}
    if not (out["capacity_retries"] == retry.stats()["capacity_retries"] == len(caps) - 1
            and out["retry_bytes"] == sum(DIST_SHARDS * DIST_SHARDS * c * row_bytes for c in caps)):
        raise AssertionError(f"runtime exchange: the retry contract counted {out}, predicted "
                             f"{len(caps) - 1} doublings through {caps}")
    metrics.reset()
    print(f"runtime exchange (metrics armed): shuffle.bytes_exchanged {got} = the padded wire "
          f"bytes; the retry contract at capacity {cap0} doubled {len(caps) - 1} times through "
          f"{caps} (largest bucket {biggest}), {out['retry_bytes']} B counted", flush=True)
    return out


def _boundary_cost() -> dict:
    """(a) host microseconds a call, median of ``RUNTIME_CALLS``: a bare
    function, the same wrapped by ``op_boundary`` and disarmed, and
    wrapped with metrics and tracing armed (each armed call a one-op
    trace: span, flight recorder, record_function and NVTX ranges)."""
    from spark_rapids_jni_tpu_torch.utils import metrics, trace_sink, tracing
    from spark_rapids_jni_tpu_torch.utils.dispatch import op_boundary

    def bare(x):
        return x

    wrapped = op_boundary("runtime.noop")(bare)

    def per_call_us(fn):
        fn(1)
        ns = []
        for _ in range(RUNTIME_CALLS):
            t0 = time.perf_counter_ns()
            fn(1)
            ns.append(time.perf_counter_ns() - t0)
        return float(np.median(ns)) / 1e3

    out = {"bare_us": per_call_us(bare), "disarmed_us": per_call_us(wrapped)}
    with metrics.enabled(), tracing.enabled():
        out["armed_us"] = per_call_us(wrapped)
    metrics.reset()
    trace_sink.reset_for_tests()
    return out


def _runtime_chaos() -> dict:
    """(c) the rest of the chaos on the card: a ``hang`` on multiply128
    against ``deadline_s``, and a real out-of-memory inside a wrapped op."""
    import torch
    from spark_rapids_jni_tpu_torch.columnar import Column
    from spark_rapids_jni_tpu_torch.columnar import dtype as pdt
    from spark_rapids_jni_tpu_torch.ops import decimal_utils
    from spark_rapids_jni_tpu_torch.utils import faultinj
    from spark_rapids_jni_tpu_torch.utils.dispatch import op_boundary
    from spark_rapids_jni_tpu_torch.utils.errors import DeadlineExceeded, RetryableError

    limbs = torch.zeros((1000, 4), dtype=torch.int32, device="cuda")
    a = Column(pdt.decimal128(SPARK_SCALE), data=limbs)
    faultinj.configure({"faults": {"multiply128": {"type": "hang", "delayMs": 5000}}})
    t0 = time.perf_counter()
    try:
        decimal_utils.multiply128(a, a, PRODUCT_SCALE, deadline_s=HANG_DEADLINE_S)
        raise AssertionError("runtime: a hang under a deadline returned")
    except DeadlineExceeded as e:
        hang_s = time.perf_counter() - t0
        msg = str(e)
    finally:
        faultinj.disable()
    if hang_s > HANG_DEADLINE_S + HANG_SLACK_S:
        raise AssertionError(f"runtime: the hang raised after {hang_s:.3f} s, past "
                             f"{HANG_DEADLINE_S} + {HANG_SLACK_S} s")
    print(f"runtime: hang rule on multiply128 with deadline_s={HANG_DEADLINE_S} raised "
          f"DeadlineExceeded after {hang_s:.3f} s ({msg})", flush=True)

    free, total = torch.cuda.mem_get_info()

    @op_boundary("runtime.alloc")
    def alloc(nbytes):
        return torch.empty(nbytes, dtype=torch.uint8, device="cuda")

    try:
        alloc(free + (1 << 30))
        raise AssertionError("runtime: an allocation past the free memory returned")
    except RetryableError as e:
        if not isinstance(e.__cause__, torch.OutOfMemoryError):
            raise
        oom = str(e).splitlines()[0][:120]
    print(f"runtime: a wrapped allocation of {free + (1 << 30)} B (free {free}) raised "
          f"RetryableError: {oom}", flush=True)
    return {"hang_s": hang_s, "hang_deadline_s": HANG_DEADLINE_S, "hang_slack_s": HANG_SLACK_S,
            "oom_bytes": free + (1 << 30), "oom": "RetryableError"}


# ---------------------------------------------------------------------------
# the exchange path: the cross-process TCP exchange (parallel/shuffle's
# TcpExchange and its worker harness, parallel/cluster.ClusterView)
# ---------------------------------------------------------------------------

EXCHANGE_WORLD = 4
# (b)'s demo table: 4,194,304 rows of INT64 k and v a rank (64 MB), the
# shuffle output of one Spark map task at the default 128 MB split
EXCHANGE_ROWS = 16_777_216
EXCHANGE_ROUNDS = 4  # (b)'s rounds without chaos; the last two are the steady state
EXCHANGE_WARM = 3  # (a)'s warm runs of each plan
EXCHANGE_RETRY = dict(max_attempts=40, base_delay_ms=25, max_delay_ms=250)  # the worker's
EXCHANGE_DEVICE = "cuda"  # "cpu" only to rehearse the phase without a card
# (b)'s runs: (label, cluster, rounds, chaos). Without a cluster a world of
# 4 takes the tree plan; a cluster pins the direct plan; the chaos run
# arms ci/chaos_cluster.json in the children (rank 2 is killed)
EXCHANGE_FLEETS = (("tree", False, EXCHANGE_ROUNDS, False), ("cluster", True, EXCHANGE_ROUNDS, False),
                   ("chaos", True, 1, True))


def _exchange_inputs(seed: int, device):
    """(a)'s input: the join path's fact batch (``_join_inputs``) with an
    INT64 ``row_id``, as host arrays and as a table on ``device``."""
    from spark_rapids_jni_tpu_torch.columnar import Table
    from spark_rapids_jni_tpu_torch.columnar import dtype as pdt
    from spark_rapids_jni_tpu_torch.interop import carry_table

    (fa, fv), _ = _join_inputs(seed)
    fa, fv = fa + [np.arange(FACT_ROWS, dtype=np.int64)], fv + [None]
    names = [n for n, _ in FACT_COLS] + ["row_id"]
    dtypes = [_pdtype(pdt, t) for _, t in FACT_COLS] + [pdt.INT64]
    return fa, fv, Table(carry_table(fa, dtypes, fv, device=device).columns, names)


def _np_exchange_plans(dest: np.ndarray, world: int):
    """Each rank's received row ids under both plans, from every row's
    destination rank, and the rows each plan moves between ranks. The
    direct plan: source rank order, then row order. The tree plan: the
    hypercube rounds simulated, each round's held rows the kept partitions
    in rank order followed by the partner's frame."""
    from spark_rapids_jni_tpu_torch.parallel.shuffle import _shard_bounds

    n = dest.shape[0]
    shards = [np.arange(*_shard_bounds(n, world, r)) for r in range(world)]
    direct = [np.concatenate([s[dest[s] == d] for s in shards]) for d in range(world)]
    moved_direct = sum(int((dest[s] != r).sum()) for r, s in enumerate(shards))
    held, moved_tree = shards, 0
    for j in range(world.bit_length() - 1):
        keep, send = [], []
        for r in range(world):
            by = [held[r][dest[held[r]] == p] for p in range(world)]
            keep.append([seg for p, seg in enumerate(by) if (p >> j) & 1 == (r >> j) & 1])
            send.append(np.concatenate([seg for p, seg in enumerate(by)
                                        if (p >> j) & 1 != (r >> j) & 1]))
            moved_tree += send[-1].shape[0]
        held = [np.concatenate(keep[r] + [send[r ^ (1 << j)]]) for r in range(world)]
    return {"all_to_all": direct, "tree": held}, {"all_to_all": moved_direct, "tree": moved_tree}


def _check_exchanged(table, fa, fv, row_ids, names, what: str) -> None:
    """A rank's received table against the numpy gather of the input by
    the row ids the plan predicts: order, every column's bits (DECIMAL128
    limbs included) and validity."""
    if table.names != names or table.num_rows != row_ids.shape[0]:
        raise AssertionError(f"{what}: received {table.names} x {table.num_rows}, expected "
                             f"{row_ids.shape[0]} rows")
    got_ids = table.column("row_id").data.cpu().numpy()
    if not np.array_equal(np.sort(got_ids), np.sort(row_ids)):
        raise AssertionError(f"{what}: the received rows are not the rows routed here")
    if not np.array_equal(got_ids, row_ids):
        raise AssertionError(f"{what}: the received rows are in another order than the plan's")
    for name, col, a, v in zip(names, table.columns, fa, fv):
        data, valid = _np_gather(a, v, row_ids)
        if not np.array_equal(col.to_numpy().view(np.uint8), np.ascontiguousarray(data).view(np.uint8)):
            raise AssertionError(f"{what}: column {name} differs from the numpy gather")
        if not np.array_equal(col.valid_mask().cpu().numpy(), valid):
            raise AssertionError(f"{what}: validity of {name} differs from the numpy gather")


def _b1_recorder():
    """A recorder in front of B1's wrapper (``hashing.partition_map``, which
    ``hash_partition`` reaches) that keeps every call under a lock, from
    any thread. Returns (install, restore, check): ``check`` holds every
    recorded call against ``partition_map_plain``, forgets them and
    returns how many there were."""
    import threading

    import torch
    from spark_rapids_jni_tpu_torch.ops import hashing
    from spark_rapids_jni_tpu_torch.ops import hopper_kernels as hk

    real, calls, lock = hashing.partition_map, [], threading.Lock()

    def rec(keys, num_partitions, valid=None):
        out = real(keys, num_partitions, valid)
        if keys.shape[0]:  # an empty call launches nothing
            with lock:
                calls.append((keys, num_partitions, valid, out))
        return out

    def install():
        hashing.partition_map = rec

    def restore():
        hashing.partition_map = real

    def check(what: str) -> int:
        for keys, p, valid, got in calls:
            if not torch.equal(got, hk.partition_map_plain(keys, p, valid)):
                raise AssertionError(f"{what}: B1 differs from its plain version on "
                                     f"[{keys.shape[0]}] {keys.dtype} keys")
        n = len(calls)
        calls.clear()
        return n

    return install, restore, check


def _exchange_world(exs, shards, key: str, epoch: int, topology):
    """Every rank's ``exchange_table`` in its own thread, then the rounds'
    frames dropped. Returns ({rank: table}, host ms to the last join)."""
    import threading

    import torch
    from spark_rapids_jni_tpu_torch.parallel.shuffle import _TREE_EPOCH_STRIDE

    addrs = {r: ex.address for r, ex in enumerate(exs)}
    out, errs = {}, []

    def run(r):
        try:
            out[r] = exs[r].exchange_table(shards[r], [key],
                                           {q: a for q, a in addrs.items() if q != r},
                                           epoch=epoch, topology=topology)
        except BaseException as e:  # re-raised below, after every join
            errs.append(e)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(len(exs))]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if any(t.is_alive() for t in threads):
        raise AssertionError(f"exchange: a rank never finished its {topology} round")
    if errs:
        raise errs[0]
    for ex in exs:
        for e in (epoch, epoch + _TREE_EPOCH_STRIDE, epoch + 2 * _TREE_EPOCH_STRIDE):
            ex.drop_epoch(e)
    return out, ms


def _exchange_split(ex_src, ex_dst, shard, world: int) -> dict:
    """One rank's frames alone, median of 3: the encode of its world - 1
    outgoing partitions, one fetch of each over loopback by a second
    exchange (no other traffic) and their decode onto the device; the wire
    time is the fetch less the decode. Beside it, the host CRC's rate over
    the same bytes."""
    import torch
    from spark_rapids_jni_tpu_torch.columnar import frames
    from spark_rapids_jni_tpu_torch.ops.copying import slice_table
    from spark_rapids_jni_tpu_torch.parallel import shuffle
    from spark_rapids_jni_tpu_torch.utils import integrity

    part, offsets = shuffle.hash_partition(shard, world, ["item_sk"])
    bounds = list(offsets) + [part.num_rows]
    parts = {p: slice_table(part, bounds[p], bounds[p + 1]) for p in range(1, world)}
    runs = []
    for i in range(3):  # epochs 900+ lie above every run's
        t0 = time.perf_counter()
        blobs = {p: frames.encode_table(t) for p, t in parts.items()}
        t1 = time.perf_counter()
        for b in blobs.values():
            frames.decode_table(b, where="shuffle.exchange", device=ex_dst.device)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        ex_src.publish(900 + i, parts)
        t3 = time.perf_counter()
        for p in parts:
            ex_dst.fetch(ex_src.address, 900 + i, p)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        ex_src.drop_epoch(900 + i)
        c0 = time.perf_counter()
        for b in blobs.values():
            integrity.checksum(b)
        c1 = time.perf_counter()
        runs.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3, (t4 - t3) * 1e3, (c1 - c0) * 1e3))
    enc, dec, fetch, crc = (float(np.median([r[k] for r in runs])) for k in range(4))
    nbytes = sum(len(b) for b in blobs.values())
    wire = fetch - dec
    return {"frames": len(blobs), "frame_bytes": nbytes, "encode_ms": enc, "decode_ms": dec,
            "fetch_ms": fetch, "wire_ms": wire,
            "loopback_gbs": nbytes / (wire * 1e6) if wire > 0 else None,
            "crc_ms": crc, "crc_gbs": nbytes / (crc * 1e6) if crc > 0 else None,
            "crc": integrity.checksum_name()}


def _exchange_first(run, topology: str, fa, fv, names, want, moved, row_bytes) -> dict:
    """(a)'s counted run of one plan: B1 recorded (each call held bit for
    bit against its plain version), metrics armed for the wire bytes, and
    every rank's table checked against the numpy plan."""
    import torch
    from spark_rapids_jni_tpu_torch.columnar import column
    from spark_rapids_jni_tpu_torch.utils import metrics

    install, restore, check = _b1_recorder()
    reg = metrics.registry()
    b0, h0 = reg.value("shuffle.tcp.bytes_in"), dict(column.H2D)
    torch.cuda.reset_peak_memory_stats()
    install()
    try:
        with metrics.enabled():
            got, first_ms = run(topology)
    finally:
        restore()
    b1 = check(f"exchange (a) {topology}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    wire = reg.value("shuffle.tcp.bytes_in") - b0
    h2d = {k: column.H2D[k] - h0[k] for k in h0}
    for r in range(EXCHANGE_WORLD):
        _check_exchanged(got[r], fa, fv, want[topology][r], names,
                         f"exchange (a) {topology} rank {r}")
    dense = moved[topology] * row_bytes
    print(f"exchange (a) {topology}: every rank's rows, order, columns and validity the numpy "
          f"plan's; {b1} B1 calls bit for bit their plain version; first run {first_ms:.2f} ms "
          f"(host clock); wire {wire} B against {dense} dense B of the {moved[topology]} rows "
          f"moved; H2D {h2d['copies']} copies, {h2d['bytes']} B; peak {peak:.2f} GiB", flush=True)
    return {"first_ms": first_ms, "b1_calls": b1, "wire_bytes": wire,
            "rows_moved": moved[topology], "dense_bytes_moved": dense, "h2d": h2d,
            "peak_gib": peak}


def _exchange_warm(run, topology: str) -> dict:
    """(a)'s warm runs of one plan (host clock) and one profiled run."""
    from spark_rapids_jni_tpu_torch.ops import hopper_kernels as hk

    warm = [run(topology)[1] for _ in range(EXCHANGE_WARM)]
    print(f"exchange (a) {topology}: warm median of {EXCHANGE_WARM} "
          f"{float(np.median(warm)):.2f} ms (host clock, runs {[round(x, 2) for x in warm]})",
          flush=True)
    print(f"exchange (a) profile of {topology}:", flush=True)
    prof = _profile_phase(lambda: run(topology), top=8,
                          watch={"partition_map_kernel": hk.partition_map})
    return {"warm_ms": float(np.median(warm)), "warm_runs_ms": warm, "profile": prof}


def _close_fleet(procs) -> None:
    for p in procs.values():
        if p.poll() is None:
            try:
                p.stdin.close()
                p.wait(timeout=30)
            except Exception:  # a child that will not stop is killed
                p.kill()
                p.wait()


def _exchange_fleet(full, oracle, dev, label: str, *, cluster: bool, rounds: int,
                    chaos: bool) -> dict:
    """(b): ranks 1-3 spawned through ``spawn_exchange_fleet`` on the same
    device, this process rank 0. ``rounds`` rounds of the demo group-by
    (round i at epoch 2i), then every rank's ``_local_groupby_sum`` held
    bit for bit to the single-host one. ``chaos`` arms
    ci/chaos_cluster.json in the children and follows the reference's
    four-rank chaos acceptance step for step."""
    import os
    import threading

    import torch
    from spark_rapids_jni_tpu_torch.ops.copying import concatenate, slice_table
    from spark_rapids_jni_tpu_torch.parallel import cluster as cluster_mod
    from spark_rapids_jni_tpu_torch.parallel import shuffle
    from spark_rapids_jni_tpu_torch.utils import deadline, metrics, retry

    world = EXCHANGE_WORLD
    names = ("cluster.deaths", "cluster.transitions", "cluster.recoveries")
    c0 = {n: metrics.registry().value(n) for n in names}
    cfg = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ci", "chaos_cluster.json")
    env = {r: {"SRJTORCH_FAULTINJ_CONFIG": cfg} for r in range(1, world)} if chaos else None
    shard_of = lambda r: slice_table(full, *shuffle._shard_bounds(EXCHANGE_ROWS, world, r))  # noqa: E731
    ex0 = shuffle.TcpExchange(0, device=dev)
    procs, view, stop = {}, None, threading.Event()
    seen = {}
    try:
        t0 = time.perf_counter()
        procs, peers = shuffle.spawn_exchange_fleet(
            ex0.address, EXCHANGE_ROWS, SEED + 15, world=world, cluster=cluster, rounds=rounds,
            extra_env_by_rank=env, device=EXCHANGE_DEVICE, ready_timeout_s=300)
        startup_s = time.perf_counter() - t0
        others = {r: a for r, a in peers.items() if r != 0}
        if chaos:
            def watch_kill():  # when rank 2 exits, within a few ms
                while procs[2].poll() is None and not stop.is_set():
                    time.sleep(0.005)
                seen.setdefault("exit", time.monotonic())

            threading.Thread(target=watch_kill, daemon=True).start()
        if cluster:
            def on_transition(r, old, new):
                seen.setdefault((r, new), time.monotonic())

            view = cluster_mod.ClusterView(0, dict(peers), ex0, lineage=shard_of,
                                           on_transition=on_transition)
            view.start()
        shard0 = shard_of(0)
        round_ms = []
        res = {}
        with deadline.scope(300), retry.enabled(**EXCHANGE_RETRY):
            for rnd in range(rounds):
                torch.cuda.synchronize()
                t = time.perf_counter()
                local = ex0.exchange_table(shard0, ["k"], others, epoch=2 * rnd, cluster=view)
                torch.cuda.synchronize()
                round_ms.append((time.perf_counter() - t) * 1e3)
            res[0] = shuffle._local_groupby_sum(local)
            del local
            live = [r for r in range(1, world) if not (chaos and r == 2)]
            if chaos:
                if not view.await_dead(2, 120):
                    raise AssertionError("exchange (b) chaos: rank 2 was never declared dead")
                rc2 = procs[2].wait(timeout=120)
                if rc2 == 0:
                    raise AssertionError("exchange (b) chaos: rank 2 exited cleanly, not killed")
            for r in live:
                got = ex0.fetch(peers[r], 2 * rounds - 1, r)
                res[r] = type(got)(got.columns, ["k", "s", "c"])
            if chaos:
                res[2] = shuffle._local_groupby_sum(view.recompute_dead_partition(2, ["k"], world))
        t_answer = time.monotonic()
        got = concatenate([res[r] for r in range(world)])
        order = np.argsort(got.column("k").data.cpu().numpy(), kind="stable")
        for name in ("k", "s", "c"):
            if not np.array_equal(got.column(name).data.cpu().numpy()[order], oracle[name]):
                raise AssertionError(f"exchange (b) {label}: {name} differs from the single-host "
                                     "group-by")
        deltas = {n: metrics.registry().value(n) - c0[n] for n in names}
        entry = {"startup_s": startup_s, "round_ms": round_ms, "rounds": rounds,
                 "steady_ms": float(np.mean(round_ms[-2:])) if rounds >= 2 else None,
                 "counters": deltas, "cluster": cluster}
        if chaos:
            want = {"cluster.deaths": 1, "cluster.transitions": 2}
            if (view.dead_ranks() != [2] or view.generation() != 2 or ex0.generation() != 2
                    or any(deltas[k] != v for k, v in want.items())
                    or deltas["cluster.recoveries"] < 1):
                raise AssertionError(f"exchange (b) chaos: dead {view.dead_ranks()}, generation "
                                     f"{view.generation()} / {ex0.generation()}, counters {deltas}")
            entry.update({"rank2_rc": rc2, "generation": view.generation(),
                          "kill_to_dead_s": seen[(2, "dead")] - seen["exit"],
                          "kill_to_suspect_s": seen[(2, "suspect")] - seen["exit"],
                          "kill_to_answer_s": t_answer - seen["exit"]})
        elif cluster and (deltas["cluster.deaths"] or deltas["cluster.transitions"]):
            raise AssertionError(f"exchange (b) {label}: transitions without a fault: {deltas}")
        return entry
    finally:
        stop.set()
        if view is not None:
            view.stop()
        _close_fleet(procs)
        ex0.close()
        shuffle.exchange_breaker().reset()


def _exchange_phase(wrappers) -> tuple:
    """The exchange path: (a) four ranks in one process, one thread each,
    each holding one row shard of the fact batch, under both plans; (b) four
    processes. The counted run holds (a)'s first runs and all of (b): every
    B1 call of this process is recorded and held against its plain
    version, their number must be the plans' prediction, and no other
    kernel may launch. (a)'s warm runs, profiles and one rank's
    encode / wire / decode split follow. Returns (paths entry, launches)."""
    import torch
    from spark_rapids_jni_tpu_torch.ops.copying import slice_table
    from spark_rapids_jni_tpu_torch.parallel import shuffle
    from spark_rapids_jni_tpu_torch.utils import retry

    t_phase = time.perf_counter()
    world = EXCHANGE_WORLD
    dev = torch.device(EXCHANGE_DEVICE, 0) if EXCHANGE_DEVICE == "cuda" else torch.device("cpu")
    fa, fv, table = _exchange_inputs(SEED + 14, dev)
    names = list(table.names)
    shards = [slice_table(table, *shuffle._shard_bounds(table.num_rows, world, r))
              for r in range(world)]
    want, moved = _np_exchange_plans(_np_partition(fa[1], fv[1], world), world)
    row_bytes = sum(np.ascontiguousarray(a[:1]).nbytes + (v is not None) for a, v in zip(fa, fv))
    torch.cuda.synchronize()
    print(f"exchange input (a): the fact batch {FACT_ROWS} x {len(FACT_COLS)} and a row id "
          f"({row_bytes} B a row with its validity bytes), {world} row shards on {dev}, made and "
          f"uploaded in {time.perf_counter() - t_phase:.1f} s", flush=True)
    exs = [shuffle.TcpExchange(r, device=dev) for r in range(world)]
    epoch = [0]

    def run(topology):
        epoch[0] += 1
        return _exchange_world(exs, shards, "item_sk", epoch[0], topology)

    def counted():
        a = {t: _exchange_first(run, t, fa, fv, names, want, moved, row_bytes)
             for t in ("all_to_all", "tree")}
        t0 = time.perf_counter()
        full = shuffle._demo_table(EXCHANGE_ROWS, SEED + 15, device=dev)
        host = shuffle._local_groupby_sum(full)
        oracle = {n: host.column(n).data.cpu().numpy() for n in ("k", "s", "c")}
        print(f"exchange input (b): the demo table, {EXCHANGE_ROWS} rows (k in [0, 64), v), "
              f"{EXCHANGE_ROWS // world} a rank, and its single-host group-by in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        install, restore, check = _b1_recorder()
        b = {}
        for label, cluster, rounds, chaos in EXCHANGE_FLEETS:
            torch.cuda.reset_peak_memory_stats()
            install()
            try:
                e = _exchange_fleet(full, oracle, dev, label, cluster=cluster, rounds=rounds,
                                    chaos=chaos)
            finally:
                restore()
            e["b1_calls"] = check(f"exchange (b) {label}")
            e["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            extra = "" if not chaos else (
                f"; rank 2 killed (rc {e['rank2_rc']}), suspect {e['kill_to_suspect_s']:.3f} s "
                f"and dead {e['kill_to_dead_s']:.3f} s after its exit, the answer "
                f"{e['kill_to_answer_s']:.3f} s after it, generation {e['generation']}")
            print(f"exchange (b) {label}: the {world} ranks' group-bys bit for bit the "
                  f"single-host one; workers started in {e['startup_s']:.1f} s; rank 0's rounds "
                  f"(host ms) {[round(x, 2) for x in e['round_ms']]}, steady (mean of the last "
                  f"two) {e['steady_ms']}; {e['b1_calls']} B1 calls at rank 0, each bit for bit "
                  f"its plain version; counters {e['counters']}; peak {e['peak_gib']:.2f} GiB"
                  + extra, flush=True)
            b[label] = e
        return a, b

    try:
        with retry.enabled(max_attempts=40, base_delay_ms=5, max_delay_ms=50):
            (a, b), launches = _run_counted(wrappers, counted)
            log2 = world.bit_length() - 1
            tree_b = world >= 4 and world & (world - 1) == 0  # auto's choice without a cluster
            # (a): one hash_partition a rank for the direct plan, one a rank
            # and round for the tree; (b) at rank 0: one a round (log2 a tree
            # round), and in the chaos round rank 0's recovery of rank 2's
            # partitions and the recompute of rank 2's share
            predicted = {"a_all_to_all": world, "a_tree": world * log2,
                         **{f"b_{label}": rounds * (log2 if tree_b and not cluster else 1)
                            + 2 * chaos for label, cluster, rounds, chaos in EXCHANGE_FLEETS}}
            got = {"a_all_to_all": a["all_to_all"]["b1_calls"], "a_tree": a["tree"]["b1_calls"],
                   **{f"b_{k}": v["b1_calls"] for k, v in b.items()}}
            print(f"exchange path launches: {launches}; B1 calls {got}, predicted {predicted}",
                  flush=True)
            if got != predicted:
                raise AssertionError(f"exchange: B1 calls {got} differ from the prediction "
                                     f"{predicted}")
            others = {k: v for k, v in launches.items() if k != "partition_map" and v}
            if others:
                raise AssertionError(f"the exchange path launched kernels it does not run: {others}")
            if EXCHANGE_DEVICE == "cuda" and launches["partition_map"] != sum(got.values()):
                raise AssertionError(f"the exchange path launched B1 {launches['partition_map']} "
                                     f"times, {sum(got.values())} calls recorded")
            for t in a:
                a[t].update(_exchange_warm(run, t))
            split = _exchange_split(exs[0], exs[1], shards[0], world)
    finally:
        for ex in exs:
            ex.close()
    print(f"exchange (a) one rank's {split['frames']} frames ({split['frame_bytes']} B), median "
          f"of 3: encode {split['encode_ms']:.2f} ms, fetch {split['fetch_ms']:.2f} ms of which "
          f"decode {split['decode_ms']:.2f} ms and wire {split['wire_ms']:.2f} ms "
          f"({split['loopback_gbs']} GB/s loopback); host CRC ({split['crc']}) "
          f"{split['crc_ms']:.2f} ms ({split['crc_gbs']} GB/s)", flush=True)
    wall = time.perf_counter() - t_phase
    print(f"exchange phase: {wall:.1f} s wall (inputs, the counted run with its checks, (a) warm "
          f"and profiled, the split)", flush=True)
    return ({"world": world, "rows_a": FACT_ROWS, "rows_b": EXCHANGE_ROWS, "row_bytes_a": row_bytes,
             "in_process": a, "split": split, "cross_process": b, "b1_calls": got,
             "b1_predicted": predicted, "phase_wall_s": wall, "launches": launches}, launches)


# ---------------------------------------------------------------------------
# the plan path: the plan tier's TPC-DS queries through compile_ir
# ---------------------------------------------------------------------------

# the TPC-DS specification's SF1 fact cardinalities; gen_channels takes
# store_sales' rows and gives web_sales and catalog_sales half as many each
PLAN_ROWS = {"gen_store_wide": 2_880_404, "gen_store": 2_880_404, "gen_catalog": 1_441_548,
             "gen_web": 719_384, "gen_store_returns": 287_514, "gen_channels": 2_880_404}
PLAN_HAND_BUILT = ("q3", "q55")  # q3_plan / q55_plan against models/tpcds' hand-built queries
PLAN_ORACLES = ("q1", "q38", "q10", "q9")  # one a class: decorrelated, INTERSECT, EXISTS, CASE
PLAN_PPART = 200  # the ppart projection's partitions (spark.sql.shuffle.partitions)
PLAN_KERNELS = ("partition_map", "probe_paged", "groupby_sum_outer")
PLAN_DEVICE = "cuda"  # "cpu" only to rehearse the phase without a card


def _plan_queries():
    """(name, plan builder, generator name, generator, seed) of every
    query the path runs: the registry's 25 and q3_plan / q55_plan."""
    from spark_rapids_jni_tpu_torch.models import tpcds as ptpcds
    from spark_rapids_jni_tpu_torch.models import tpcds_plans as tp

    out = [(name, d.plan, d.gen.generator.__name__, d.gen.generator, d.gen.seed)
           for name, d in sorted(tp.PLAN_QUERIES.items(), key=lambda kv: int(kv[0][1:]))]
    out += [(f"{q}_plan", getattr(tp, f"{q}_plan"), "gen_store", ptpcds.gen_store, 42 + i)
            for i, q in enumerate(PLAN_HAND_BUILT)]
    return out


def _plan_inputs(device):
    """One table set a generator (at ``PLAN_ROWS``, the registry's seed)
    on ``device``, and a CPU copy of each: gen name -> (tables, cpu)."""
    from spark_rapids_jni_tpu_torch.columnar import Column, Table

    def cpu(t):
        return Table([Column(c.dtype, data=c.data.cpu(),
                             validity=None if c.validity is None else c.validity.cpu())
                      for c in t.columns], list(t.names))

    out = {}
    for _, _, gname, gen, seed in _plan_queries():
        if gname not in out:
            tabs = gen(PLAN_ROWS[gname], seed=seed, device=device)
            out[gname] = (tabs, {k: cpu(t) for k, t in tabs.items()})
    return out


def _plan_compile(plan, tables, name: str):
    """``compile_ir`` with its three parts timed by the host clock:
    (CompiledPlan, {rewrite_ms, stats_ms (the sketches), cbo_ms,
    lower_ms (the rest: schema inference, lowering, the bounded-domain
    scans), compile_ms})."""
    from spark_rapids_jni_tpu_torch import plan as P
    from spark_rapids_jni_tpu_torch.plan import compiler, optimizer, stats

    spent = {"rewrite_ms": 0.0, "stats_ms": 0.0, "cbo_ms": 0.0}

    def timed(key, fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[key] += (time.perf_counter() - t0) * 1e3
        return run

    saved = compiler.rewrite, stats.make_estimator, optimizer.optimize
    compiler.rewrite = timed("rewrite_ms", saved[0])
    stats.make_estimator = timed("stats_ms", saved[1])
    optimizer.optimize = timed("cbo_ms", saved[2])
    try:
        t0 = time.perf_counter()
        cp = P.compile_ir(plan(), tables, name=name)
        total = (time.perf_counter() - t0) * 1e3
    finally:
        compiler.rewrite, stats.make_estimator, optimizer.optimize = saved
    spent["lower_ms"] = total - sum(spent.values())
    spent["compile_ms"] = total
    return cp, spent


def _plan_capture(cps):
    """Run every compiled plan once, timed by the host clock to a
    synchronize, with recorders in front of B1 (``hashing.partition_map``),
    B4 (``join.probe_paged``) and B3 (``aggregate.groupby_sum_outer``):
    each non-empty call is kept with its output, to be held against the
    plain version after the run. Returns (results, first-run ms by query,
    calls by query and kernel, the recorded calls)."""
    import torch
    from spark_rapids_jni_tpu_torch.ops import aggregate, hashing, join

    saved = hashing.partition_map, join.probe_paged, aggregate.groupby_sum_outer
    seen = []

    def rec(kernel, fn, rows):
        def run(*args):
            out = fn(*args)
            if rows(args):  # an empty call launches nothing
                seen.append((kernel, args, out))
            return out
        return run

    hashing.partition_map = rec("partition_map", saved[0], lambda a: a[0].shape[0])
    join.probe_paged = rec("probe_paged", saved[1], lambda a: a[0].shape[0])
    aggregate.groupby_sum_outer = rec("groupby_sum_outer", saved[2], lambda a: a[0].shape[0])
    out, stage, calls, recorded = {}, {}, {}, {}
    try:
        for name, cp in cps.items():
            seen.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[name] = cp()
            torch.cuda.synchronize()
            stage[f"{name}_ms"] = (time.perf_counter() - t0) * 1e3
            calls[name] = {k: sum(s[0] == k for s in seen) for k in PLAN_KERNELS}
            recorded[name] = list(seen)
    finally:
        hashing.partition_map, join.probe_paged, aggregate.groupby_sum_outer = saved
    stage["end_to_end_ms"] = sum(stage.values())
    return out, stage, calls, recorded


def _check_plan_kernel_calls(recorded) -> dict:
    """Every recorded B1 / B4 call bit for bit against its plain version,
    every B3 call's counts exact and its sums within B3's bound (rtol
    2e-6, atol 1e-3, ``tests/test_pallas_kernels.py:65-66``). Returns the
    checked calls by kernel and B3's largest sum error."""
    import torch
    from spark_rapids_jni_tpu_torch.ops import hopper_kernels as hk

    checked = {k: 0 for k in PLAN_KERNELS}
    b3_err = 0.0
    for name, seen in recorded.items():
        for kernel, args, got in seen:
            if kernel == "partition_map":
                same = torch.equal(got, hk.partition_map_plain(*args))
            elif kernel == "probe_paged":
                want = hk.probe_paged_plain(*args)
                same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            else:
                want = hk.groupby_sum_outer_plain(*args)
                b3_err = max(b3_err, float((got[0].double() - want[0].double()).abs().max())
                             if got[0].numel() else 0.0)
                same = torch.equal(got[1], want[1]) and torch.allclose(
                    got[0].double(), want[0].double(), rtol=2e-6, atol=1e-3)
            if not same:
                raise AssertionError(f"plan {name}: {kernel} differs from its plain version "
                                     f"on [{args[0].shape[0]}] {args[0].dtype} keys")
            checked[kernel] += 1
    return {"checked": checked, "b3_max_abs_err": b3_err}


# var / std's two-pass M2 sums float64 with index_add_ (the atomics of
# the card, in another order than the CPU's): the one FLOAT64 result
# outside the exact accumulator, held to this relative tolerance
PLAN_FLOAT_SUM_RTOL = 1e-9


def _plan_float_sum_columns(cp) -> set:
    """The names of a compiled plan's var / std outputs, and of every
    projected column computed from one: the columns whose float64 sums
    are not the exact accumulator's."""
    from spark_rapids_jni_tpu_torch.plan import nodes as N

    nodes = _plan_nodes(cp.optimized)
    names = {a.name for n in nodes if isinstance(n, N.Aggregate) for a in n.aggs
             if a.how in ("var", "std", "var_pop", "stddev_pop")}
    grew = True
    while grew:
        grew = False
        for n in [x for x in nodes if isinstance(x, N.Project)]:
            for name, e in n.exprs:
                if name not in names and e.refs() & names:
                    names.add(name)
                    grew = True
    return names


def _plan_nodes(root) -> list:
    out, seen, todo = [], set(), [root]
    while todo:
        n = todo.pop()
        if id(n) not in seen:
            seen.add(id(n))
            out.append(n)
            todo.extend(n.inputs())
    return out


def _same_plan_result(got, want, what: str, float_sums=()) -> float:
    """Two result tables bit for bit (names, types, data bits, which
    columns carry a validity mask, and the masks), wherever they live;
    the FLOAT64 columns named in ``float_sums`` within
    ``PLAN_FLOAT_SUM_RTOL`` instead. Returns their largest relative
    error (0.0 when there are none)."""
    if got.names != want.names or got.num_rows != want.num_rows:
        raise AssertionError(f"{what}: {got.names} x {got.num_rows} differs from "
                             f"{want.names} x {want.num_rows}")
    worst = 0.0
    for name, g, w in zip(want.names, got.columns, want.columns):
        gd, wd = g.data.cpu().numpy(), w.data.cpu().numpy()
        gv, wv = g.valid_mask().cpu().numpy(), w.valid_mask().cpu().numpy()
        if (g.dtype != w.dtype or (g.validity is None) != (w.validity is None)
                or not np.array_equal(gv, wv)):
            raise AssertionError(f"{what}: column {name} differs")
        if name in float_sums and g.dtype.id.name == "FLOAT64":
            a, b = gd.view(np.float64)[gv], wd.view(np.float64)[wv]
            rel = np.abs(a - b) / np.maximum(np.abs(b), np.finfo(np.float64).tiny)
            worst = max(worst, float(rel.max()) if rel.size else 0.0)
            if not np.allclose(a, b, rtol=PLAN_FLOAT_SUM_RTOL, atol=0.0):
                raise AssertionError(f"{what}: column {name} differs beyond rtol "
                                     f"{PLAN_FLOAT_SUM_RTOL}")
        elif not np.array_equal(gd.view(np.uint8), wd.view(np.uint8)):
            raise AssertionError(f"{what}: column {name} differs")
    return worst


def _plan_oracle(q: str, h) -> dict:
    """The numpy oracle of registry query ``q`` at its default parameters
    over the host arrays ``h``: result columns, every float the nearest
    float64 of the exact rational."""
    dd = h["date_dim"]
    if q == "q1":  # decorrelated: returns above 1.2x their store's average
        sr = h["store_returns"]
        keep = dd["d_year"][sr["sr_returned_date_sk"]] == 1998
        (gc, gs), nums, e0, _ = _exact_groups(
            sr["sr_return_amt"][keep], [sr["sr_customer_sk"][keep], sr["sr_store_sk"][keep]])
        total = _rounded(nums, e0)
        (us,), snums, se0, scnt = _exact_groups(total, [gs])
        avg = dict(zip(us.tolist(), _rounded(snums, se0, scnt).tolist()))
        sel = (total > np.array([avg[s] for s in gs.tolist()]) * 1.2)
        sel &= h["store"]["s_state"][gs] == 3
        return {"c_customer_id": np.sort(h["customer"]["c_customer_id"][gc[sel]])[:100]}
    window = {"q38": (1999, 1, 7), "q10": (1999, 1, 4)}.get(q)
    if window is not None:
        ok = (dd["d_year"] == window[0]) & (dd["d_moy"] >= window[1]) & (dd["d_moy"] <= window[2])

        def active(fact, ccol, dcol):
            f = h[fact]
            return np.unique(f[ccol][ok[f[dcol]]])

        store = active("store_sales", "ss_customer_sk", "ss_sold_date_sk")
        cat = active("catalog_sales", "cs_ship_customer_sk", "cs_sold_date_sk")
        web = active("web_sales", "ws_bill_customer_sk", "ws_sold_date_sk")
        cu = h["customer"]
        if q == "q38":  # INTERSECT of the three channels' customer ids
            ids = [set(cu["c_customer_id"][a].tolist()) for a in (store, cat, web)]
            return {"cnt": np.array([len(ids[0] & ids[1] & ids[2])], np.int64)}
        # q10: in-state customers with store AND (web OR catalog) activity
        sk = cu["c_customer_sk"]
        keep = (np.isin(h["customer_address"]["ca_state"][cu["c_current_addr_sk"]], (1, 4, 7))
                & np.isin(sk, store) & np.isin(sk, np.union1d(web, cat)))
        demo = cu["c_current_cdemo_sk"][keep]
        cd = h["customer_demographics"]
        names = ("cd_gender", "cd_marital_status", "cd_education_status")
        keys = np.stack([cd[n][demo] for n in names], axis=1)
        uniq, cnt = np.unique(keys, axis=0, return_counts=True)
        return {**{n: uniq[:, i] for i, n in enumerate(names)}, "cnt": cnt.astype(np.int64)}
    if q == "q9":  # CASE over each quantity band's global count and averages
        ss = h["store_sales"]
        vals = []
        for i, th in enumerate((2100, 2100, 2100, 2100, 1800)):
            band = (ss["ss_quantity"] >= 1 + 20 * i) & (ss["ss_quantity"] <= 20 + 20 * i)
            n = int(band.sum())
            src = ss["ss_ext_sales_price"] if n > th else ss["ss_coupon_amt"]
            nums, e0 = _exact_sums(src[band], np.zeros(n, np.int64), 1)
            vals.append(_frac_float(nums[0], e0, n))
        return {"bucket": np.arange(5, dtype=np.int64), "val": np.array(vals, np.float64)}
    raise ValueError(f"no oracle for {q}")


def _check_plan_oracle(q: str, out, h) -> int:
    """The query's result against its numpy oracle: every column exact
    (floats by their bits). Returns the result's rows."""
    want = _plan_oracle(q, h)
    if list(want) != out.names:
        raise AssertionError(f"plan {q}: columns {out.names}, the oracle's {list(want)}")
    for name, w in want.items():
        c = out.column(name)
        got = c.to_numpy()
        got = got.view(np.float64) if c.dtype.id.name == "FLOAT64" else got.astype(np.int64)
        if c.validity is not None and not bool(c.valid_mask().all()):
            raise AssertionError(f"plan {q}: column {name} has nulls the oracle does not")
        if w.dtype == np.float64:  # floats by their bits
            got, w = got.view(np.uint64), w.view(np.uint64)
        if got.shape != w.shape or not np.array_equal(got, w):
            raise AssertionError(f"plan {q}: column {name} differs from the numpy oracle "
                                 f"({got[:8]} against {w[:8]})")
    return out.num_rows


def _plan_ppart(tabs):
    """One ``ppart`` projection over store_sales: B1 at the fact's full
    size, through the plan tier. Returns (compiled plan, the projection's
    numpy oracle)."""
    from spark_rapids_jni_tpu_torch import plan as P

    ss = tabs["store_sales"]
    ir = P.Project(P.Scan("store_sales"), (("p", P.ppart(("ss_item_sk",), PLAN_PPART)),))
    keys = ss.column("ss_item_sk").to_numpy()
    return (P.compile_ir(ir, {"store_sales": ss}, name="ppart"),
            _np_pmod(_np_murmur([keys]), PLAN_PPART).astype(np.int32))


def _plan_seed(gname: str) -> int:
    """The seed ``_plan_inputs`` made a generator's tables with (the first
    query's of that generator)."""
    return next(s for _, _, g, _, s in _plan_queries() if g == gname)


def _plan_phase(wrappers, keep=None) -> tuple:
    """The plan path: inputs, each query compiled (its parts timed), the
    counted run with every B1 / B4 / B3 call recorded and held against its
    plain version, every check (the CPU run of the same plan on the same
    tables, the hand-built q3 / q55, four numpy oracles, the inferred
    schema, the peak blowup), the ppart projection, then each query warm
    and profiled. Returns (paths entry, launches). ``keep`` (a dict) gets
    the gen_store and gen_store_wide tables with their seeds and the card
    q55_plan result, for the memgov path."""
    import torch
    from spark_rapids_jni_tpu_torch import plan as P
    from spark_rapids_jni_tpu_torch.models import tpcds as ptpcds
    from spark_rapids_jni_tpu_torch.ops import hopper_kernels as hk

    t_phase = time.perf_counter()
    inputs = _plan_inputs(PLAN_DEVICE)
    torch.cuda.synchronize()
    print("plan input: " + "; ".join(
        f"{g} ({PLAN_ROWS[g]} rows: " + ", ".join(f"{t} {tb.num_rows}" for t, tb in tabs.items())
        + ")" for g, (tabs, _) in inputs.items())
        + f"; made on the host, uploaded, and copied to the CPU in "
        f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    queries = _plan_queries()
    cps, compile_ms = {}, {}
    for name, plan, gname, _, _ in queries:
        cps[name], compile_ms[name] = _plan_compile(plan, inputs[gname][0], name)
    (out, stage, calls, recorded), launches = _run_counted(wrappers, lambda: _plan_capture(cps))
    total = {k: sum(c[k] for c in calls.values()) for k in PLAN_KERNELS}
    print(f"plan path launches: {launches}; calls recorded by kernel {total}", flush=True)
    others = {k: v for k, v in launches.items() if k not in PLAN_KERNELS and v}
    if others:
        raise AssertionError(f"the plan path launched kernels it does not run: {others}")
    if PLAN_DEVICE == "cuda" and any(launches[k] != total[k] for k in PLAN_KERNELS):
        raise AssertionError(f"the plan path launched {launches}, recorded {total}")
    t0 = time.perf_counter()
    kcheck = _check_plan_kernel_calls(recorded)
    del recorded
    print(f"plan: every recorded call held against its plain version ({kcheck['checked']}, B1 "
          f"and B4 bit for bit; B3's sums within rtol 2e-6 / atol 1e-3, max abs err "
          f"{kcheck['b3_max_abs_err']:.3g}) in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    cpu_ms, rows, reports, float_sums = {}, {}, {}, {}
    for name, plan, gname, _, _ in queries:
        got = out[name]
        cp = cps[name]
        executed = {n: c.dtype for n, c in zip(got.names, got.columns)}
        if executed != cp.schema:
            raise AssertionError(f"plan {name}: executed dtypes {executed} differ from the "
                                 f"inferred schema {cp.schema}")
        rep = cp.last_report
        if rep["peak_blowup"] is not None and rep["peak_blowup"] > 2.5:
            raise AssertionError(f"plan {name}: peak blowup {rep['peak_blowup']} above 2.5")
        t1 = time.perf_counter()
        ccp = P.compile_ir(plan(), inputs[gname][1], name=name)
        if P.structure(ccp.optimized) != P.structure(cp.optimized) or [
                (s.kind, s.est_rows, s.est_bytes) for s in ccp.stages] != [
                (s.kind, s.est_rows, s.est_bytes) for s in cp.stages]:
            raise AssertionError(f"plan {name}: the CPU tables compile to another plan")
        fs = _plan_float_sum_columns(cp) & set(got.names)
        err = _same_plan_result(got, ccp(), f"plan {name} on the card against the CPU", fs)
        if fs:
            float_sums[name] = {"columns": sorted(fs), "max_rel_err": err}
        cpu_ms[name] = (time.perf_counter() - t1) * 1e3
        rows[name] = got.num_rows
        reports[name] = {k: rep[k] for k in ("nodes_raw", "nodes_optimized", "fused_stages",
                                             "est_peak_bytes", "actual_peak_bytes",
                                             "peak_blowup", "memgov_admitted_bytes")}
        reports[name]["stages"] = [s["kind"] for s in rep["stages"]]
    print(f"plan path checked against the port's CPU run of the same plans on the same tables "
          f"(names, types, data bits and masks identical; the same optimized plans and "
          f"estimates) in {time.perf_counter() - t0:.1f} s; held to rtol {PLAN_FLOAT_SUM_RTOL} "
          f"instead, the var / std columns (float64 index_add_ sums): {float_sums}; inferred "
          f"schemas equal the executed dtypes; peak blowup at most 2.5", flush=True)
    for q in PLAN_HAND_BUILT:
        tabs = inputs["gen_store"][0]
        _same_plan_result(out[f"{q}_plan"], getattr(ptpcds, q)(tabs),
                          f"plan {q}_plan against the hand-built {q}")
    oracle_rows = {}
    for q in PLAN_ORACLES:
        gname = next(g for n, _, g, _, _ in queries if n == q)
        oracle_rows[q] = _check_plan_oracle(q, out[q], _host_star(inputs[gname][0]))
    print(f"plan: q3_plan / q55_plan bit for bit the hand-built q3 / q55; {', '.join(PLAN_ORACLES)} "
          f"equal their numpy oracles (rows {oracle_rows})", flush=True)
    if keep is not None:
        for g in ("gen_store", "gen_store_wide"):
            keep[g] = (inputs[g][0], _plan_seed(g))
        keep["q55_plan"] = out["q55_plan"]
    del out
    # B1 at the fact's full size, through a ppart projection
    pcp, want = _plan_ppart(inputs["gen_store_wide"][0])
    (pout, ppart_launches) = _run_counted(wrappers, pcp)
    if PLAN_DEVICE == "cuda" and (ppart_launches["partition_map"] != 1 or any(
            v for k, v in ppart_launches.items() if k != "partition_map")):
        raise AssertionError(f"the ppart projection launched {ppart_launches}, not B1 once")
    got = pout.column("p").data
    keys = inputs["gen_store_wide"][0]["store_sales"].column("ss_item_sk")
    if not (np.array_equal(got.cpu().numpy(), want)
            and torch.equal(got, hk.partition_map_plain(keys.data, PLAN_PPART, keys.validity))):
        raise AssertionError("plan ppart: the partition ids differ from the numpy murmur3 / "
                             "the plain version")
    pms = _time_ms(pcp, reps=5, warm=1) if PLAN_DEVICE == "cuda" else None
    print(f"plan ppart projection over store_sales ({keys.data.shape[0]} INT32 keys, "
          f"{PLAN_PPART} partitions): B1 launched {ppart_launches['partition_map']} time(s), ids "
          f"equal to the numpy murmur3 and the plain version; {pms} ms a call", flush=True)
    del pout, pcp, want
    launches = {k: v + (ppart_launches[k] if k == "partition_map" else 0)
                for k, v in launches.items()}
    # each query warm, then profiled
    warm, peak, profiles = _warm_and_profile(
        "plan", cps, stage, {"partition_map_kernel": hk.partition_map,
                             "probe_fenced_kernel": hk.probe_paged,
                             "groupby_outer_kernel": hk.groupby_sum_outer})
    for name in cps:
        c = compile_ms[name]
        kinds = reports[name]["stages"]
        print(f"plan {name}: compile {c['compile_ms']:.2f} ms (rewrite {c['rewrite_ms']:.2f}, "
              f"sketches {c['stats_ms']:.2f}, CBO {c['cbo_ms']:.2f}, lowering {c['lower_ms']:.2f}); "
              f"first run {stage[name + '_ms']:.2f}, warm {warm[name + '_ms']:.2f} ms; peak "
              f"{peak.get(name, float('nan')):.2f} GiB; stages fused {kinds.count('fused_aggregate')}"
              f" / operator tier {len(kinds) - kinds.count('fused_aggregate')}; rewrites "
              f"{cps[name].rewrites_fired}; launches {calls[name]}; rows {rows[name]}; CPU run "
              f"{cpu_ms[name]:.0f} ms", flush=True)
    wall = time.perf_counter() - t_phase
    print(f"plan phase: {wall:.1f} s wall (input, compiles, counted run, checks, CPU runs, "
          f"warm runs, profiles)", flush=True)
    return ({**stage, "warm": warm, "warm_end_to_end_ms": warm["end_to_end_ms"],
             "rows": PLAN_ROWS, "result_rows": rows, "compile_ms": compile_ms,
             "cpu_run_ms": cpu_ms, "reports": reports, "calls": calls, **kcheck,
             "float_sum_columns": float_sums,
             "oracle_rows": oracle_rows, "ppart_ms": pms, "peak_gib": peak,
             "phase_wall_s": wall, "launches": launches, "profile": profiles}, launches)


# ---------------------------------------------------------------------------
# the memgov path: the plan tier across processes, out-of-core plans,
# spilled build tables, the plan and subresult caches, the xgboost bridge
# ---------------------------------------------------------------------------

MEMGOV_DEVICE = "cuda"  # "cpu" only to rehearse the phase without a card
MEMGOV_WORLD = 4  # (a): this process rank 0, three worker processes
MEMGOV_CACHE_QUERY = "q96"  # (d): a registry plan over the plan path's gen_store_wide
MEMGOV_REBIND = {("int", 20, None): 8}  # (d): q96's hour 20 -> 8
CRITEO_ROWS = 4_194_304  # (e): 2^22 rows of Criteo's shape
CRITEO_DENSE, CRITEO_CATS = 13, 26  # Criteo's I1-I13 and C1-C26
CRITEO_BINS = 256  # XGBoost's default max_bin
MEMGOV_KERNELS = ("partition_map", "probe_paged", "groupby_sum_outer")


def _memgov_env(**values):
    """Set ``SRJTORCH_<name>`` knobs for a ``with`` block (None unsets)."""
    import contextlib
    import os

    @contextlib.contextmanager
    def scope():
        saved = {k: os.environ.get("SRJTORCH_" + k) for k in values}
        try:
            for k, v in values.items():
                if v is None:
                    os.environ.pop("SRJTORCH_" + k, None)
                else:
                    os.environ["SRJTORCH_" + k] = str(v)
            yield
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop("SRJTORCH_" + k, None)
                else:
                    os.environ["SRJTORCH_" + k] = v

    return scope()


def _memgov_recorders():
    """Recorders in front of B1 (``hashing.partition_map``), B4
    (``join.probe_paged``) and B3 (``aggregate.groupby_sum_outer``) that
    keep every non-empty call with its output, from any thread. Returns
    (install, restore, take): ``take`` hands the calls recorded since the
    last take to ``_check_plan_kernel_calls`` and returns its result."""
    import threading

    from spark_rapids_jni_tpu_torch.ops import aggregate, hashing, join

    saved = hashing.partition_map, join.probe_paged, aggregate.groupby_sum_outer
    seen, lock = [], threading.Lock()

    def rec(kernel, fn):
        def run(*args):
            out = fn(*args)
            if args[0].shape[0]:  # an empty call launches nothing
                with lock:
                    seen.append((kernel, args, out))
            return out
        return run

    def install():
        hashing.partition_map = rec("partition_map", saved[0])
        join.probe_paged = rec("probe_paged", saved[1])
        aggregate.groupby_sum_outer = rec("groupby_sum_outer", saved[2])

    def restore():
        hashing.partition_map, join.probe_paged, aggregate.groupby_sum_outer = saved

    def take(what: str) -> dict:
        with lock:
            calls = list(seen)
            seen.clear()
        return _check_plan_kernel_calls({what: calls})

    return install, restore, take


def _memgov_inputs(keep: dict) -> dict:
    """The earlier paths' tables and card results this path reuses (the
    tpch path's lineitem, the plan path's gen_store / gen_store_wide and
    its card q55_plan result, the join path's fact and dimension); what
    ``keep`` lacks (a ``--memgov-only`` run) is made here the same way."""
    import torch
    from spark_rapids_jni_tpu_torch import plan as P
    from spark_rapids_jni_tpu_torch.columnar import Table
    from spark_rapids_jni_tpu_torch.columnar import dtype as pdt
    from spark_rapids_jni_tpu_torch.interop import carry_table
    from spark_rapids_jni_tpu_torch.models import tpcds as ptpcds, tpch
    from spark_rapids_jni_tpu_torch.models import tpcds_plans as tp

    got = dict(keep)
    made = []
    if "lineitem" not in got:
        got["lineitem"] = tpch.gen_lineitem(LINEITEM_ROWS, seed=SEED + 4, device=MEMGOV_DEVICE)
        made.append("lineitem")
    for gname, gen in (("gen_store", ptpcds.gen_store), ("gen_store_wide", ptpcds.gen_store_wide)):
        if gname not in got:
            seed = next(s for _, _, g, _, s in _plan_queries() if g == gname)
            got[gname] = (gen(PLAN_ROWS[gname], seed=seed, device=MEMGOV_DEVICE), seed)
            made.append(gname)
    if "q55_plan" not in got:
        got["q55_plan"] = P.compile_ir(tp.q55_plan(), got["gen_store"][0], name="q55_plan")()
        made.append("q55_plan")
    if "join" not in got:
        (fa, fv), (da, dv) = _join_inputs(SEED + 2)
        fact = Table(carry_table(fa, [_pdtype(pdt, t) for _, t in FACT_COLS], fv,
                                 device=MEMGOV_DEVICE).columns, [n for n, _ in FACT_COLS])
        dim = Table(carry_table(da, [_pdtype(pdt, t) for _, t in DIM_COLS], dv,
                                device=MEMGOV_DEVICE).columns, [n for n, _ in DIM_COLS])
        got["join"] = (fact, dim)
        made.append("join")
    torch.cuda.synchronize()
    got["made"] = made
    return got


def _memgov_q55(store, seed: int, want) -> dict:
    """(a): q55 with exchange stages at world 4 on the one card: ranks 1-3
    are ``--query q55`` worker processes over ``gen_store(rows, seed)``,
    this process is rank 0 over the same tables; the merged partials equal
    the plan path's single-process card result bit for bit."""
    from spark_rapids_jni_tpu_torch import plan as P
    from spark_rapids_jni_tpu_torch.columnar import Table
    from spark_rapids_jni_tpu_torch.models import tpcds_plans as tp
    from spark_rapids_jni_tpu_torch.ops.copying import slice_table
    from spark_rapids_jni_tpu_torch.parallel import shuffle
    from spark_rapids_jni_tpu_torch.plan.distribute import merge_partials
    from spark_rapids_jni_tpu_torch.utils import retry

    import torch

    world = MEMGOV_WORLD
    rows = store["store_sales"].num_rows
    sales = store["store_sales"]

    def shard_tables(r):
        out = dict(store)
        out["store_sales"] = slice_table(sales, *shuffle._shard_bounds(rows, world, r))
        return out

    plan = P.insert_exchanges(tp.q55_plan(), world)
    ex0 = shuffle.TcpExchange(0, device=MEMGOV_DEVICE)
    procs = {}
    try:
        t0 = time.perf_counter()
        procs, peers = shuffle.spawn_exchange_fleet(
            ex0.address, PLAN_ROWS["gen_store"], seed, world=world, query="q55",
            device=MEMGOV_DEVICE, ready_timeout_s=300)
        startup_s = time.perf_counter() - t0
        others = {r: a for r, a in peers.items() if r != 0}
        t0 = time.perf_counter()
        with retry.enabled(max_attempts=400, base_delay_ms=25, max_delay_ms=250):
            with P.exchange_context(ex0, others, shard_tables=shard_tables):
                part0 = P.compile_ir(plan, shard_tables(0), name="q55@r0")()
            parts = [part0] + [Table(ex0.fetch(others[r], 1, r).columns, list(want.names))
                               for r in range(1, world)]
        merged = merge_partials(parts, [("ext_price", False), ("i_brand_id", True)])
        round_s = time.perf_counter() - t0
    finally:
        _close_fleet(procs)
        ex0.close()
    bad = {r: p.returncode for r, p in procs.items() if p.returncode != 0}
    if bad:
        raise AssertionError(f"memgov (a): q55 workers exited {bad}")
    # the exchange-stage plan's aggregate keeps an all-valid mask on its
    # key where the plain plan has none: data bits and valid rows compared
    if merged.names != want.names or merged.num_rows != want.num_rows or any(
            g.dtype != w.dtype
            or not torch.equal(g.valid_mask().cpu(), w.valid_mask().cpu())
            or not np.array_equal(g.data.cpu().numpy().view(np.uint8),
                                  w.data.cpu().numpy().view(np.uint8))
            for g, w in zip(merged.columns, want.columns)):
        raise AssertionError("memgov (a): the merged q55 partials differ from the "
                             "single-process card q55_plan")
    return {"world": world, "rows": rows, "seed": seed, "fleet_startup_s": startup_s,
            "round_s": round_s, "result_rows": merged.num_rows,
            "partial_rows": [p.num_rows for p in parts]}


def _memgov_ooc(ir, tables, label: str) -> dict:
    """(b): ``ir`` in core, then out of core with the device budget at its
    estimate // 4; bit for bit, spills > 0 and no partition entry left."""
    import torch
    from spark_rapids_jni_tpu_torch import memgov
    from spark_rapids_jni_tpu_torch import plan as P

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    incore_cp = P.compile_ir(ir, tables, name=f"{label}_incore")
    want = incore_cp()
    torch.cuda.synchronize()
    incore_ms = (time.perf_counter() - t0) * 1e3
    est = incore_cp.estimated_memory_bytes
    budget = est // 4
    with _memgov_env(OOC_ENABLED=1, DEVICE_MEMORY_BUDGET=budget, OOC_PARTITIONS=None), \
            memgov.enabled():
        t0 = time.perf_counter()
        cp = P.compile_ir(ir, tables, name=f"{label}_ooc")
        if not isinstance(cp, P.OutOfCorePlan):
            raise AssertionError(f"memgov (b) {label}: out of core was not selected")
        got = cp()
        torch.cuda.synchronize()
        ooc_ms = (time.perf_counter() - t0) * 1e3
        kinds = memgov.catalog().kind_stats("partition")
    _same_plan_result(got, want, f"memgov (b) {label}: out of core against in core")
    rep = cp.last_report
    if rep["spills"] <= 0 or kinds != (0, 0):
        raise AssertionError(f"memgov (b) {label}: spills {rep['spills']}, partition entries "
                             f"left {kinds}")
    return {"rows": next(iter(tables.values())).num_rows, "keys": list(cp._target.key_cols),
            "est_bytes": est, "budget_bytes": budget, "partitions": cp.partitions,
            "partition_peak_bytes": cp.partition_memory_bytes, "spills": rep["spills"],
            "resumes": rep["resumes"], "incore_ms": incore_ms, "ooc_ms": ooc_ms,
            "result_rows": got.num_rows}


def _memgov_builds(fact, dim) -> dict:
    """(c): the join path's dimension registered as the build table of a
    dense-join pipeline over its fact batch, then forced to host and to
    disk with ``spill_until`` / ``spill``; every call's output bit for bit
    the explicit-builds call's. Rates from the host clock."""
    import torch
    from spark_rapids_jni_tpu_torch import memgov
    from spark_rapids_jni_tpu_torch import pipeline as pp

    plan = pp.PlanSpec(
        joins=(pp.JoinSpec(build="dim", probe_key="item_sk", build_key="item_sk",
                           num_keys=ITEM_DOMAIN, payload=("i_brand_id", "i_manufact_id")),),
        aggregates=(pp.Agg("i_manufact_id", "sum"), pp.Agg("i_brand_id", "max"),
                    pp.Agg("ss_quantity", "sum"), pp.Agg("ss_ext_sales_price", "count")))
    pipe = pp.compile_plan(plan)
    want = pipe(fact, {"dim": dim})
    memgov.reset()
    cat = memgov.catalog()
    pipe.register_build("dim", dim)
    h = pipe._build_handles["dim"]
    nbytes = h.nbytes

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t

    outs = [pipe(fact)]
    d2h = timed(lambda: cat.spill_until(nbytes, name="memgov.builds"))
    tiers = [h.tier]
    outs.append(pipe(fact))  # re-materializes host -> device, pinned
    h.spill()
    h2d = timed(h.get)
    h.spill()
    write = timed(lambda: h.spill(to_disk=True))
    tiers.append(h.tier)
    disk_get = timed(h.get)
    outs.append(pipe(fact))
    tiers.append(h.tier)
    for i, got in enumerate(outs):
        _same_plan_result(got, want, f"memgov (c): call {i} with the registered build")
    pipe.unregister_builds()
    if tiers != ["host", "disk", "device"] or cat.snapshot()["entries"] != 0:
        raise AssertionError(f"memgov (c): tiers {tiers}, entries {cat.snapshot()['entries']}")
    gb = nbytes / 1e9
    read = max(disk_get - h2d, 1e-9)
    return {"build_rows": dim.num_rows, "build_bytes": nbytes, "fact_rows": fact.num_rows,
            "d2h_gbps": gb / d2h, "h2d_gbps": gb / h2d, "frame_write_gbps": gb / write,
            "disk_to_device_gbps": gb / disk_get, "frame_read_gbps": gb / read,
            "d2h_ms": d2h * 1e3, "h2d_ms": h2d * 1e3, "frame_write_ms": write * 1e3,
            "disk_to_device_ms": disk_get * 1e3}


def _memgov_caches(tables) -> dict:
    """(d): a registry plan through ``cache.compile_cached``: a miss, the
    plan re-parameterized with ``rebind_literals`` (a rebind hit, its
    result bit for bit a fresh compile's), then the first plan again (an
    exact hit whose stages are subresult hits)."""
    import torch
    from spark_rapids_jni_tpu_torch import cache, memgov
    from spark_rapids_jni_tpu_torch import plan as P
    from spark_rapids_jni_tpu_torch.models import tpcds_plans as tp
    from spark_rapids_jni_tpu_torch.utils import metrics

    reg = metrics.registry()
    names = ("hits", "misses", "rebinds", "sub_hits", "sub_misses", "insert_verified")
    c0 = {n: reg.value(f"cache.{n}") for n in names}
    plan_a = tp.PLAN_QUERIES[MEMGOV_CACHE_QUERY].plan()
    plan_b = P.rebind_literals(plan_a, MEMGOV_REBIND)

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    with _memgov_env(PLAN_CACHE=1, SUBRESULT_CACHE=1):
        cache.reset()
        qa, miss_ms = timed(lambda: cache.compile_cached(plan_a, tables, name="cache_a"))
        ra, run_a_ms = timed(qa)
        qb, rebind_ms = timed(lambda: cache.compile_cached(plan_b, tables, name="cache_b"))
        rb, run_b_ms = timed(qb)
        qa2, hit_ms = timed(lambda: cache.compile_cached(plan_a, tables, name="cache_a"))
        ra2, run_hit_ms = timed(qa2)
        governed = memgov.catalog().kind_stats("cache")
        cache.reset()
    d = {n: reg.value(f"cache.{n}") - c0[n] for n in names}
    _same_plan_result(rb, P.compile_ir(plan_b, tables, name="cache_fresh")(),
                      "memgov (d): the rebound plan against a fresh compile")
    _same_plan_result(ra2, ra, "memgov (d): the subresult hit against the first run")
    if d["misses"] != 1 or d["rebinds"] != 1 or d["hits"] != 2 or d["sub_hits"] < 1:
        raise AssertionError(f"memgov (d): cache counters {d}")
    return {"query": MEMGOV_CACHE_QUERY, "rebind": {str(k): v for k, v in MEMGOV_REBIND.items()},
            "miss_compile_ms": miss_ms, "rebind_compile_ms": rebind_ms,
            "exact_hit_compile_ms": hit_ms, "first_run_ms": run_a_ms,
            "rebound_run_ms": run_b_ms, "subresult_hit_run_ms": run_hit_ms,
            "governed_entries_bytes": governed, "counters": d,
            "result_rows": [ra.num_rows, rb.num_rows]}


def _criteo_table(rows: int, seed: int, device):
    """A synthetic table of Criteo's shape: label (INT32 0/1, ~3% clicks),
    I1-I13 (INT32 counts, heavy-tailed, I2 down to -3, 0-45% nulls) and
    C1-C26 (INT32 hashed categorical codes from vocabularies of 10 to
    10^7 values, log-uniform ranks so that a few codes are common, 0-40%
    nulls)."""
    from spark_rapids_jni_tpu_torch.interop import carry_table
    from spark_rapids_jni_tpu_torch.columnar import Table
    from spark_rapids_jni_tpu_torch.columnar import dtype as pdt

    rng = np.random.default_rng(seed)
    arrays, valids, names = [(rng.random(rows) < 0.03).astype(np.int32)], [None], ["label"]
    null_rates = np.linspace(0.0, 0.45, CRITEO_DENSE)
    for i in range(CRITEO_DENSE):
        a = np.floor(rng.lognormal(1.0 + 0.3 * i, 1.5, rows)).astype(np.int32)
        if i == 1:
            a -= 3
        arrays.append(a)
        valids.append(rng.random(rows) >= null_rates[i])
        names.append(f"I{i + 1}")
    vocab = np.logspace(1, 7, CRITEO_CATS).astype(np.int64)
    null_rates = np.linspace(0.0, 0.4, CRITEO_CATS)
    for j in range(CRITEO_CATS):
        ranks = np.exp(rng.random(rows) * np.log(vocab[j])).astype(np.int64) - 1
        codes = ((ranks * 0x9E3779B1 + j * 0x85EBCA77) & 0x7FFFFFFF).astype(np.int32)
        arrays.append(codes)
        valids.append(rng.random(rows) >= null_rates[j])
        names.append(f"C{j + 1}")
    t = carry_table(arrays, [pdt.INT32] * len(arrays), valids, device=device)
    return Table(t.columns, names)


def _memgov_bridge(rows: int) -> dict:
    """(e): ``to_dmatrix(max_bins=256)`` over the Criteo-shaped table on
    the card; its cuts and bins bit for bit the port's CPU run of the same
    table. Time and peak device memory from the card."""
    import torch
    from spark_rapids_jni_tpu_torch.columnar import Column, Table
    from spark_rapids_jni_tpu_torch.models import xgboost_bridge as xb

    t0 = time.perf_counter()
    table = _criteo_table(rows, SEED + 17, MEMGOV_DEVICE)
    torch.cuda.synchronize()
    make_s = time.perf_counter() - t0
    feats = [f"I{i + 1}" for i in range(CRITEO_DENSE)] + [f"C{j + 1}" for j in range(CRITEO_CATS)]

    def build():
        return xb.to_dmatrix(table, feats, label_col="label", max_bins=CRITEO_BINS)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dm = build()
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() - base
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        build()
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - t0) * 1e3)
    cpu_table = Table([Column(c.dtype, data=c.data.cpu(),
                              validity=None if c.validity is None else c.validity.cpu())
                       for c in table.columns], list(table.names))
    t0 = time.perf_counter()
    cdm = xb.to_dmatrix(cpu_table, feats, label_col="label", max_bins=CRITEO_BINS)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    if not (torch.equal(dm.cuts.cpu().view(torch.int32), cdm.cuts.view(torch.int32))
            and torch.equal(dm.binned.cpu(), cdm.binned)):
        raise AssertionError("memgov (e): the card's cuts or bins differ from the CPU run's")
    if dm.binned.shape != (rows, len(feats)) or int(dm.binned.max()) > CRITEO_BINS:
        raise AssertionError(f"memgov (e): binned {tuple(dm.binned.shape)}, max "
                             f"{int(dm.binned.max())}")
    return {"rows": rows, "features": len(feats), "max_bins": CRITEO_BINS,
            "table_made_s": make_s, "first_ms": first_ms,
            "warm_ms": float(np.median(warm)), "cpu_ms": cpu_ms,
            "peak_bytes_over_inputs": peak,
            "features_bytes": dm.features.numel() * 4, "binned_bytes": dm.binned.numel() * 4,
            "missing_fraction": float((dm.binned == CRITEO_BINS).float().mean())}


def _memgov_phase(wrappers, keep: dict) -> tuple:
    """The memgov path, (a)-(e), in one counted run with every B1 / B4 /
    B3 call recorded and held against its plain version. Returns (paths
    entry, launches)."""
    from spark_rapids_jni_tpu_torch import memgov
    from spark_rapids_jni_tpu_torch import plan as P

    t_phase = time.perf_counter()
    inp = _memgov_inputs(keep)
    print(f"memgov input: reused the earlier paths' lineitem, gen_store, gen_store_wide, card "
          f"q55_plan result and join tables; made here: {inp['made'] or 'nothing'} "
          f"({time.perf_counter() - t_phase:.1f} s)", flush=True)
    install, restore, take = _memgov_recorders()
    store, seed = inp["gen_store"]
    entry = {}

    def drive():
        def part(key, fn):
            before = {k: w.launches for k, w in wrappers.items()}
            t0 = time.perf_counter()
            entry[key] = fn()
            entry[key]["wall_s"] = time.perf_counter() - t0
            entry[key]["launches"] = {k: w.launches - before[k] for k, w in wrappers.items()
                                      if w.launches - before[k]}
            entry[key]["held"] = take(f"memgov {key}")
            print(f"memgov {key}: {entry[key]}", flush=True)

        part("a_q55_world4", lambda: _memgov_q55(store, seed, inp["q55_plan"]))
        q1_ir = P.Sort(
            P.Aggregate(P.Filter(P.Scan("lineitem"), P.pcol("l_quantity") >= P.plit(0.0)),
                        keys=("l_returnflag", "l_linestatus"),
                        aggs=(P.AggSpec("l_quantity", "sum", "sum_qty"),
                              P.AggSpec("l_extendedprice", "sum", "sum_price"),
                              P.AggSpec(None, "count_all", "count_order"))),
            keys=(("l_returnflag", True), ("l_linestatus", True)))
        part("b_ooc_q1", lambda: _memgov_ooc(q1_ir, {"lineitem": inp["lineitem"]}, "q1"))
        one_key = P.Sort(
            P.Aggregate(P.Scan("store_sales"), keys=("ss_item_sk",),
                        aggs=(P.AggSpec("ss_ext_sales_price", "sum", "revenue"),
                              P.AggSpec(None, "count_all", "sales"))),
            keys=(("ss_item_sk", True),))
        part("b_ooc_one_key", lambda: _memgov_ooc(
            one_key, {"store_sales": store["store_sales"]}, "one_key"))
        part("c_spilled_builds", lambda: _memgov_builds(*inp["join"]))
        part("d_caches", lambda: _memgov_caches(inp["gen_store_wide"][0]))
        part("e_xgboost_bridge", lambda: _memgov_bridge(CRITEO_ROWS))

    install()
    try:
        _, launches = _run_counted(wrappers, drive)
    finally:
        restore()
        memgov.reset()
    for key in ("a_q55_world4", "b_ooc_one_key"):
        b1 = entry[key]["held"]["checked"]["partition_map"]
        if MEMGOV_DEVICE == "cuda" and (entry[key]["launches"].get("partition_map", 0) < 1
                                        or b1 != entry[key]["launches"]["partition_map"]):
            raise AssertionError(f"memgov {key}: B1 launched {entry[key]['launches']}, held "
                                 f"{b1} calls against its plain version")
    others = {k: v for k, v in launches.items() if k not in MEMGOV_KERNELS and v}
    if others:
        raise AssertionError(f"the memgov path launched kernels it does not run: {others}")
    wall = time.perf_counter() - t_phase
    print(f"memgov phase: {wall:.1f} s wall; launches {launches}", flush=True)
    entry.update({"phase_wall_s": wall, "launches": launches, "reused": not inp["made"],
                  "made_here": inp["made"]})
    return entry, launches


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

    t_script = time.perf_counter()
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
    if "--memgov-only" in sys.argv[1:]:
        entry, _ = _memgov_phase(wrappers, {})
        print(json.dumps({"memgov_only": entry, "card": smi_line}), flush=True)
        return 4  # a partial run: one path driven
    keep = {}  # earlier paths' tables and card results the memgov path reuses
    if "--plan-only" in sys.argv[1:]:
        entry, _ = _plan_phase(wrappers)
        print(json.dumps({"plan_only": {k: entry[k] for k in ("launches", "calls", "result_rows",
                                                              "phase_wall_s")},
                          "card": smi_line}), flush=True)
        return 4  # a partial run: one path driven

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
    t_rt = time.perf_counter()
    mem0 = torch.cuda.memory_allocated()
    rt_fixed, rt_launches = _runtime_fixed(wrappers, table, dtypes, layout, rows, dec, sums, counts)
    rt_wall = time.perf_counter() - t_rt
    rt_fixed["allocated_before_after"] = (mem0, torch.cuda.memory_allocated())
    print(f"runtime fixed: device bytes allocated before / after its checks "
          f"{rt_fixed['allocated_before_after']}", flush=True)
    # the checks' outputs are gone by now; a retried error kept alive by a
    # reference cycle would hold a row blob (792 MB) until the collector ran
    if rt_fixed["allocated_before_after"][1] > mem0 + (64 << 20):
        raise AssertionError("runtime fixed: its checks left device memory allocated")
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
    t_rt = time.perf_counter()
    rt_join, rt_jlaunches = _runtime_join(wrappers, fact, dim, part, offsets, joined, sums, counts)
    rt_wall += time.perf_counter() - t_rt
    rt_launches = {k: v + rt_jlaunches[k] for k, v in rt_launches.items()}
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

    keep["join"] = (fact, dim)
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
    keep["lineitem"] = li
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

    # -- the distributed path: the in-mesh tier on the tpcds path's stars ---
    for star in set(stars) - {s for _, s in DIST_QUERIES}:
        del stars[star]
    torch.cuda.empty_cache()
    paths["distributed"], mlaunches = _dist_phase(wrappers, stars)
    del stars
    torch.cuda.empty_cache()

    # -- the plan path: the plan tier's TPC-DS queries ------------------------
    paths["plan"], planlaunches = _plan_phase(wrappers, keep)
    torch.cuda.empty_cache()

    # -- the memgov path: distributed q55, out of core, spills, caches, bridge
    paths["memgov"], memlaunches = _memgov_phase(wrappers, keep)
    del keep
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

    # -- the runtime path: the op boundary around the paths ------------------
    # (its armed runs, profiler ranges, retry, fatal and split checks ran on
    # the fixed and join paths' tables, its exchange check on the
    # distributed path's mesh; the boundary's cost and the rest of the chaos
    # here)
    t_rt = time.perf_counter()
    cost = _boundary_cost()
    print(f"runtime boundary cost (host us a call, median of {RUNTIME_CALLS}): bare "
          f"{cost['bare_us']:.3f}, wrapped disarmed {cost['disarmed_us']:.3f}, wrapped armed "
          f"(metrics and tracing) {cost['armed_us']:.3f}", flush=True)
    chaos = _runtime_chaos()
    rt_wall += time.perf_counter() - t_rt
    paths["runtime"] = {
        "boundary_cost": cost, "fixed": rt_fixed, "join": rt_join, "chaos": chaos,
        "exchange": paths["distributed"].pop("runtime_exchange"),
        "warm_end_to_end_ms_with_boundary": {"fixed": warm["end_to_end_ms"],
                                             "join": jwarm["end_to_end_ms"]},
        "phase_wall_s": rt_wall, "launches": rt_launches}
    print(f"runtime path: the fixed and join paths warm with the boundary in place (disarmed): "
          f"{warm['end_to_end_ms']:.2f} / {jwarm['end_to_end_ms']:.2f} ms; armed runs "
          f"{rt_fixed['armed_ms']:.2f} / {rt_join['armed_ms']:.2f} ms; launches of the armed runs "
          f"{rt_launches}; phase {rt_wall:.1f} s wall", flush=True)

    # -- the exchange path: the cross-process TCP exchange --------------------
    paths["exchange"], exlaunches = _exchange_phase(wrappers)
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
                              "tpcds": dlaunches[k], "distributed": mlaunches[k],
                              "plan": planlaunches[k], "memgov": memlaunches[k],
                              "spark_exact": xlaunches[k], "string_ops": solaunches[k],
                              "io": iolaunches[k], "runtime": rt_launches[k],
                              "exchange": exlaunches[k]},
         "max_abs_err": r["max_abs_err"], "ms": r["ms"], "kernel_ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"],
         **{x: r[x] for x in ("library", "parts", "device_ms", "host_us", "library_host_us",
                              "max_abs_err_vs_b3", "layouts_ms", "function_level",
                              "bound_ms_int64_base", "device_call_ms", "activities_per_call",
                              "one_call_activities", "join_keys", "string_ops") if x in r}}
        for k, r in {**kernels, **skernels, **jkernels, **okernels}.items()
    ], "paths": paths, "card": smi_line}
    script_s = time.perf_counter() - t_script
    paths["runtime"]["script_wall_s"] = script_s
    print(f"chip_smoke: the whole script took {script_s:.1f} s wall", flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
