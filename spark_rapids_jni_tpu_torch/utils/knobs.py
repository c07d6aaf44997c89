"""The port's environment knob registry and typed accessors (port of the
JAX package's ``utils/knobs.py``).

Every knob the port reads is declared here once (name, type, default,
validation, one-line doc) and read through the typed ``get_*``
accessors; no other module of the port reads ``os.environ`` for a knob.
The names carry the port's own prefix, ``SRJTORCH_``, followed by the
reference knob's suffix (``SRJTORCH_RETRY_ENABLED`` is the counterpart of
the reference's ``RETRY_ENABLED`` knob), so that the reference's knob
linter, which scans for its own prefix, never sees a port knob.

Parsing posture, as the reference's: a malformed value WARNS and falls
back to the declared default (a bad knob degrades the feature, never an
import or a query); ``positive=True`` knobs also reject values <= 0 and
``minimum`` clamps an int from below. The accessors read the environment
live on every call; modules that latch a value at import (the metrics,
tracing, retry and integrity gates) do so at their own import site.

Only the knobs of the modules the port has are declared: retry, deadline
and breaker, metrics (with the adaptive-timeout reader), tracing and the
flight recorder, integrity, fault injection, the cross-process exchange,
cluster membership, the plan tier (its report, statistics and cost-based
optimizer), the memory governor with its out-of-core plans, and the plan
and subresult caches. ``markdown_table()``
renders them for the README.

``SENTINELS`` are not knobs: they are the handshake lines that spawn
harnesses poll a child's stdout for.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Optional

__all__ = [
    "PREFIX",
    "Knob",
    "declare",
    "knob",
    "all_knobs",
    "names",
    "is_declared",
    "is_set",
    "get_raw",
    "get_str",
    "get_bool",
    "get_int",
    "get_float",
    "env_float",
    "markdown_table",
    "SENTINELS",
    "EXCHANGE_READY",
]

PREFIX = "SRJTORCH_"

# the exchange worker's READY line (parallel/shuffle.py)
EXCHANGE_READY = PREFIX + "EXCHANGE_READY"
SENTINELS = frozenset({EXCHANGE_READY})

_TRUE = ("1", "true", "yes")
_FALSE = ("0", "false", "no")


class Knob:
    """One declared knob: the registry row and its validation spec."""

    __slots__ = ("name", "type", "default", "doc", "positive", "minimum",
                 "choices", "scope")

    def __init__(self, name, type, default, doc, positive=False,
                 minimum=None, choices=None, scope="python"):
        self.name = name
        self.type = type  # "bool" | "int" | "float" | "str"
        self.default = default
        self.doc = doc
        self.positive = positive  # floats/ints: value must be > 0
        self.minimum = minimum  # ints: clamp floor
        self.choices = choices  # strs: allowed values (warn + default)
        self.scope = scope


_REGISTRY: Dict[str, Knob] = {}


def declare(name: str, type: str, default, doc: str, **kw) -> Knob:
    if name in _REGISTRY:
        raise ValueError(f"knob {name} declared twice")
    if not name.startswith(PREFIX):
        raise ValueError(f"knob {name} must carry the {PREFIX} prefix")
    k = Knob(name, type, default, doc, **kw)
    _REGISTRY[name] = k
    return k


def knob(name: str) -> Knob:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"undeclared knob {name!r}: declare it in "
            "spark_rapids_jni_tpu_torch/utils/knobs.py"
        ) from None


def all_knobs() -> Iterable[Knob]:
    return [_REGISTRY[n] for n in sorted(_REGISTRY)]


def names() -> frozenset:
    return frozenset(_REGISTRY)


def is_declared(name: str) -> bool:
    return name in _REGISTRY


def _warn(msg: str) -> None:
    import warnings

    warnings.warn(f"knobs: {msg}", stacklevel=3)


def get_raw(name: str, env=None) -> Optional[str]:
    """The raw environment string for a declared knob, or None when
    unset. The untyped escape hatch: prefer the typed accessors."""
    knob(name)  # undeclared reads fail loudly, even through the API
    return (os.environ if env is None else env).get(name)


def is_set(name: str, env=None) -> bool:
    """True when the knob is present AND non-empty in the environment."""
    return bool(get_raw(name, env))


def get_str(name: str, env=None, default=...) -> Optional[str]:
    k = knob(name)
    if default is ...:
        default = k.default
    raw = get_raw(name, env)
    if raw is None or raw == "":
        return default
    if k.choices and raw.lower() not in k.choices:
        _warn(f"unknown {name}={raw!r}; using {default!r}")
        return default
    return raw.lower() if k.choices else raw


def get_bool(name: str, env=None, default=...) -> bool:
    """Tri-state text -> bool: explicit true/false spellings win, any
    other spelling warns and keeps the default, unset or empty keeps it
    silently."""
    k = knob(name)
    if default is ...:
        default = k.default
    raw = get_raw(name, env)
    if raw is None or raw == "":
        return bool(default)
    low = raw.lower()
    if low in _TRUE:
        return True
    if low in _FALSE:
        return False
    _warn(f"ignoring malformed {name}={raw!r}; using {bool(default)!r}")
    return bool(default)


def get_int(name: str, env=None, default=...) -> Optional[int]:
    k = knob(name)
    if default is ...:
        default = k.default
    raw = get_raw(name, env)
    if raw is None or raw == "":
        return default
    try:
        v = int(raw)
    except ValueError:
        _warn(f"ignoring malformed {name}={raw!r}; using {default!r}")
        return default
    if k.positive and v <= 0:
        _warn(f"{name}={raw!r} must be > 0; keeping default {default!r}")
        return default
    if k.minimum is not None:
        v = max(v, k.minimum)
    return v


def get_float(name: str, env=None, default=...) -> Optional[float]:
    k = knob(name)
    if default is ...:
        default = k.default
    return env_float(os.environ if env is None else env, name, default,
                     positive=k.positive)


def env_float(env, key: str, default, positive: bool = False):
    """Parse a float knob out of a mapping, warning and falling back to
    ``default`` on malformed input and, with ``positive=True``, on
    values <= 0."""
    raw = env.get(key)
    if raw is None or raw == "":
        return default
    try:
        v = float(raw)
    except ValueError:
        _warn(f"ignoring malformed {key}={raw!r}")
        return default
    if positive and v <= 0:
        _warn(f"{key}={raw!r} must be > 0; keeping default {default}")
        return default
    return v


def markdown_table(scope: Optional[str] = None) -> str:
    """The registry as the markdown knob table the README embeds."""
    rows = ["| knob | type | default | description |",
            "|---|---|---|---|"]
    for k in all_knobs():
        if scope is not None and k.scope != scope:
            continue
        d = "—" if k.default is None else repr(k.default).strip("'\"")
        rows.append(f"| `{k.name}` | {k.type} | `{d}` | {k.doc} |")
    return "\n".join(rows)


# ---------------------------------------------------------------------------
# the registry, grouped by subsystem; types, defaults and validation are
# the reference's
# ---------------------------------------------------------------------------

# retry orchestrator (utils/retry.py)
declare("SRJTORCH_RETRY_ENABLED", "bool", False,
        "arm op-boundary retry (bounded backoff + retry-with-split)")
declare("SRJTORCH_RETRY_MAX_ATTEMPTS", "int", 4,
        "total attempts incl. the first", positive=True)
declare("SRJTORCH_RETRY_BASE_DELAY_MS", "float", 25.0, "first backoff delay")
declare("SRJTORCH_RETRY_MAX_DELAY_MS", "float", 1000.0, "backoff ceiling")
declare("SRJTORCH_RETRY_JITTER", "float", 0.25,
        "multiplicative jitter fraction in [0,1)")
declare("SRJTORCH_RETRY_SPLIT_DEPTH", "int", 3,
        "max halvings in retry_with_split")
declare("SRJTORCH_RETRY_SEED", "int", None,
        "jitter RNG seed (deterministic chaos runs)")

# deadlines + circuit breaker (utils/deadline.py)
declare("SRJTORCH_DEADLINE_SEC", "float", None,
        "ambient per-query wall-clock budget in seconds (unset: "
        "unbounded)", positive=True)
declare("SRJTORCH_BREAKER_THRESHOLD", "int", 5,
        "consecutive failures before a circuit breaker opens",
        positive=True)
declare("SRJTORCH_BREAKER_COOLDOWN_SEC", "float", 30.0,
        "breaker open -> half-open probe delay", positive=True)

# metrics (utils/metrics.py)
declare("SRJTORCH_METRICS_ENABLED", "bool", False,
        "arm hot-path instrumentation (per-op wall time, shuffle "
        "bytes, retry/backoff counters per error class)")
declare("SRJTORCH_METRICS_LOG", "str", None,
        "append one JSON object per runtime event to this path "
        "(line-atomic, shareable across processes)")
declare("SRJTORCH_ADAPTIVE_TIMEOUT_ENABLED", "bool", True,
        "derive deadlines from observed latency quantiles (q99 x "
        "multiplier) once enough samples exist")
declare("SRJTORCH_ADAPTIVE_TIMEOUT_MULT", "float", 4.0,
        "adaptive deadline = observed op q99 x this multiplier",
        positive=True)
declare("SRJTORCH_ADAPTIVE_TIMEOUT_FLOOR_S", "float", 10.0,
        "adaptive deadlines never shrink below this floor", positive=True)
declare("SRJTORCH_ADAPTIVE_TIMEOUT_MIN_SAMPLES", "int", 40,
        "samples required before the adaptive deadline replaces the "
        "static one", minimum=1)

# tracing + flight recorder (utils/tracing.py / utils/trace_sink.py)
declare("SRJTORCH_TRACE_ENABLED", "bool", False,
        "arm per-query tracing (spans, the flight recorder) plus the "
        "torch.profiler record_function and NVTX ranges on every op "
        "boundary")
declare("SRJTORCH_TRACE_LOG", "str", None,
        "span-log base path: each process appends its finished spans "
        "(and flushed trace trees) to <base>.<pid>.jsonl")
declare("SRJTORCH_TRACE_SAMPLE", "float", 1.0,
        "fraction of root traces sampled (0 disables roots entirely)")
declare("SRJTORCH_SLOW_QUERY_SEC", "float", None,
        "flight recorder: a completed query slower than this flushes "
        "its span tree + metrics delta to the span log (failed queries "
        "always flush)", positive=True)
declare("SRJTORCH_TRACE_RING", "int", 64,
        "flight recorder ring capacity: completed query traces kept "
        "in memory", minimum=1)
declare("SRJTORCH_TRACE_MAX_SPANS", "int", 4096,
        "per-trace in-memory span cap (overflow counted; the span log "
        "is never capped)", minimum=16)

# integrity + fault injection (utils/integrity.py / utils/faultinj.py)
declare("SRJTORCH_INTEGRITY_CHECKS", "bool", True,
        "0 disables every CRC check (frames ship without CRCs, "
        "exchanges skip the checksum)")
declare("SRJTORCH_FAULTINJ_CONFIG", "str", None,
        "JSON chaos profile path (hot-reloaded on mtime change); a "
        "malformed config degrades the injector, never the process")
declare("SRJTORCH_FAULTINJ_WORKER", "str", None,
        "this process's worker tag (w0, w1, ...) for fault rule keys "
        "like op@w1")
declare("SRJTORCH_FAULTINJ_RANK", "str", None,
        "this process's rank tag (r0, r1, ...) for fault rule keys "
        "like op@r2")

# cross-process exchange (parallel/shuffle.py)
declare("SRJTORCH_EXCHANGE_MODE", "str", "mesh",
        "mesh (in-process collective) or tcp (cross-process frames); "
        "the --exchange-worker harness defaults to tcp and refuses "
        "mesh", choices=("mesh", "tcp"))
declare("SRJTORCH_EXCHANGE_TIMEOUT_SEC", "float", 30.0,
        "per-fetch deadline on the TCP exchange (always clamped by an "
        "active query deadline)", positive=True)
declare("SRJTORCH_EXCHANGE_RETAIN_EPOCHS", "int", 4,
        "published exchange rounds kept servable; older epochs are "
        "evicted on publish", minimum=1)

# cluster membership and liveness (parallel/cluster.py)
declare("SRJTORCH_CLUSTER_HEARTBEAT_SEC", "float", 0.5,
        "heartbeat cadence: each rank PINGs every peer this often; "
        "misses drive the alive -> suspect -> dead transitions",
        positive=True)
declare("SRJTORCH_CLUSTER_HEARTBEAT_TIMEOUT_SEC", "float", 2.0,
        "per-PING deadline; a PING slower than this counts as a miss",
        positive=True)
declare("SRJTORCH_CLUSTER_SUSPECT_MISSES", "int", 2,
        "consecutive heartbeat misses before an ALIVE peer is marked "
        "SUSPECT (still routable, health-degraded)", minimum=1)
declare("SRJTORCH_CLUSTER_DEAD_MISSES", "int", 4,
        "consecutive heartbeat misses before a SUSPECT peer is marked "
        "DEAD: the generation bumps and recovery engages", minimum=1)
declare("SRJTORCH_CLUSTER_QUORUM_FRACTION", "float", 0.5,
        "alive fraction (self included) at or below which the cluster "
        "is degraded", positive=True)
declare("SRJTORCH_CLUSTER_TOPOLOGY", "str", "auto",
        "exchange plan: all_to_all (direct pulls from every peer), "
        "tree (hypercube rounds, power-of-two worlds), or auto (tree "
        "iff the world is a power of two >= 4 and no cluster is "
        "attached)", choices=("auto", "all_to_all", "tree"))

# the plan tier (plan/compiler.py, plan/stats/, plan/optimizer.py)
declare("SRJTORCH_PLAN_REPORT", "str", None,
        "append one JSON line per compiled-plan execution (node counts, "
        "rewrites fired, per-stage estimate-vs-actual bytes) to this "
        "path", scope="harness")
declare("SRJTORCH_STATS_ENABLED", "bool", True,
        "collect per-column sketches (row count, min/max, HLL distinct "
        "count, equi-depth histogram, null fraction) lazily at Scan and "
        "cache them against table generation stamps; 0 falls the "
        "compiler back to its hand-tuned selectivity/width heuristics")
declare("SRJTORCH_STATS_HISTOGRAM_BINS", "int", 16,
        "equi-depth histogram bins per sketched column (more bins = "
        "tighter range-predicate selectivity, more stats memory)",
        minimum=2)
declare("SRJTORCH_STATS_HLL_BITS", "int", 9,
        "HyperLogLog register-index bits per sketched column (2^bits "
        "registers; 9 = 512 registers ~= 3.6% standard error; read "
        "sites clamp to at most 14)", minimum=4)
declare("SRJTORCH_STATS_MAX_ROWS", "int", 262144,
        "head-sample cap per column when collecting sketches (the rows "
        "copied to the host); counts above the cap are scaled back up "
        "by the sampling ratio", positive=True)
declare("SRJTORCH_CBO_ENABLED", "bool", True,
        "run the cost-based optimizer pass after the default rewrite: "
        "join-order enumeration, build-side commutes, and physical join "
        "strategy resolution, each fired as a verified rewrite with its "
        "own PLAN006 obligation (requires SRJTORCH_STATS_ENABLED)")
declare("SRJTORCH_CBO_DP_TABLES", "int", 6,
        "join-chain length up to which the exact subset-DP order search "
        "runs; longer chains use the greedy fanout-sorted fallback",
        minimum=2)
declare("SRJTORCH_CBO_CALIBRATION", "str", "artifacts/plan_compile.jsonl",
        "plan-report JSONL the byte-estimate calibration is learned "
        "from (per-stage-kind median actual/est, clamped to [0.5, 2x]); "
        "missing file = neutral factors")

# device memory (utils/memory.py)
declare("SRJTORCH_DEVICE_MEMORY_BUDGET", "int", None,
        "device byte budget for one op's working buffers (read live; "
        "unset: half the card's memory less its live allocated bytes)")

# memory governor (memgov/)
declare("SRJTORCH_HOST_MEMORY_BUDGET", "int", 0,
        "host-tier bytes before host->disk demotion (0 = unlimited)")
declare("SRJTORCH_SPILL_ENABLED", "bool", None,
        "1/0 arms/disarms the governor explicitly; unset: armed iff a "
        "device budget is declared")
declare("SRJTORCH_SPILL_DIR", "str", None,
        "disk-tier directory (unset: per-process dir under the system "
        "tempdir)")
declare("SRJTORCH_SPILL_MANIFESTS", "bool", False,
        "arm durable spill metadata: every disk-tier spill/checkpoint "
        "frame gains a CRC-framed sidecar manifest, a fresh process "
        "re-attaches surviving entries into its catalog "
        "(memgov.reattached) and a startup sweep reclaims frames owned "
        "by a provably-dead PID (memgov.orphans_reclaimed)")
declare("SRJTORCH_ADMISSION_MAX_CONCURRENT", "int", 0,
        "cap on concurrently admitted ops (0 = bytes only)")
declare("SRJTORCH_ADMISSION_MAX_WAIT_SEC", "float", 30.0,
        "admission queue wait before the retryable "
        "MemoryBudgetExceeded", positive=True)
declare("SRJTORCH_MEMGOV_HEADROOM", "float", 2.0,
        "input-bytes -> footprint multiplier for the default estimate",
        positive=True)
declare("SRJTORCH_MEMGOV_DROP_SMCACHE", "bool", False,
        "1 lets pressure drop the compiled-program cache as a last "
        "resort (the port has none, so nothing is dropped)")

# out-of-core partitioned execution (plan/ooc.py)
declare("SRJTORCH_OOC_ENABLED", "bool", False,
        "arm out-of-core degradation: a plan whose estimated peak "
        "exceeds the armed SRJTORCH_DEVICE_MEMORY_BUDGET is rewritten "
        "(partition_for_ooc, verifier-discharged) into K hash "
        "partitions streamed through the compiled plan and merged")
declare("SRJTORCH_OOC_PARTITIONS", "int", 0,
        "partition count K for out-of-core plans; 0 = the cost model's "
        "choice (smallest K <= 64 whose per-partition estimate fits "
        "half the device budget)")
declare("SRJTORCH_OOC_PREFETCH", "bool", True,
        "overlap the next partition's spill-in (catalog "
        "re-materialization) with the current partition's compute")
declare("SRJTORCH_OOC_METRICS", "str", None,
        "JSONL path appended one line per out-of-core run (partitions, "
        "resumes, lineage recomputes, spill count, wall)")
declare("SRJTORCH_OOC_DURABLE_CHECKPOINTS", "bool", False,
        "force every completed out-of-core partition checkpoint to the "
        "disk tier at registration (with SRJTORCH_SPILL_MANIFESTS this "
        "is what a restarted coordinator resumes past; off, checkpoints "
        "demote to host and die with the process)")

# plan and subresult caches (cache/)
declare("SRJTORCH_PLAN_CACHE", "bool", False,
        "arm the compiled-plan cache: compile_cached keys on the "
        "parameterized structural fingerprint, a hit skips "
        "rewrite->verify->compile and rebinds the fresh literals into "
        "the cached optimized plan (verified once per structure at "
        "insert)")
declare("SRJTORCH_SUBRESULT_CACHE", "bool", False,
        "arm the subresult cache: scan/aggregate stage outputs are "
        "registered as memgov catalog entries (kind=cache) keyed by "
        "(parameterized subtree fingerprint, literal bindings, table "
        "generations), so eviction/spill tiering/byte accounting ride "
        "the governor")
declare("SRJTORCH_CACHE_SHARING", "bool", True,
        "in-flight single-flight sharing of identical submissions: "
        "concurrent queries with one plan key attach to ONE computation "
        "and fan the result out (consulted only when "
        "SRJTORCH_PLAN_CACHE is armed)")
declare("SRJTORCH_CACHE_PLAN_ENTRIES", "int", 64,
        "parameterized-structure entries the compiled-plan cache "
        "retains (LRU past it)", minimum=1)
declare("SRJTORCH_CACHE_PLAN_VARIANTS", "int", 8,
        "fully-bound CompiledPlan variants retained per structure entry "
        "(LRU past it)", minimum=1)
declare("SRJTORCH_CACHE_SUBRESULT_BYTES", "int", 256 * 1024 * 1024,
        "byte cap on subresult-cache catalog entries; past it the cache "
        "LRU-unregisters its own entries (on top of memgov's "
        "spill/eviction pressure)", minimum=1)
