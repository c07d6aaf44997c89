"""srjt-trace merge CLI: join the port's per-process span logs into
per-trace trees and export Chrome trace-event / Perfetto JSON.

Every traced process appends its finished spans to its own
``<SRJTORCH_TRACE_LOG base>.<pid>.jsonl`` (utils/trace_sink.py) — the
client, each sidecar worker, each exchange peer. This tool joins those
logs by ``trace`` id and reconstructs the cross-process causality the
wire-propagated context (utils/tracing.py ``wire_context`` /
``remote_scope``) recorded:

    python -m spark_rapids_jni_tpu_torch.analysis.tracemerge \
        "artifacts/trace_spans*.jsonl" --format chrome \
        --out artifacts/trace_perfetto.json

Formats:

- ``chrome`` (default): ``{"traceEvents": [...]}`` complete-event
  ("ph": "X") JSON — loadable by Perfetto (ui.perfetto.dev) and
  chrome://tracing; spans keep their real pid/tid so the cross-process
  structure is visible as separate tracks.
- ``json``: the merged structure itself — per-trace span lists, root
  counts, and orphan diagnostics — the shape the gates assert against.
- ``tree``: human-readable per-trace span trees (the explain_last
  rendering, cross-process).

``--gate-orphans`` exits 1 when any span's parent does not resolve
within its trace (the zero-orphan contract: a
dropped parent means a propagation or emission bug, not chaos — chaos
kills whole processes, and a killed process's unfinished spans were
never written at all).
"""

from __future__ import annotations

import argparse
import glob as glob_mod
import json
import os
import sys
from typing import Dict, Iterable, List, Optional

__all__ = ["load_spans", "merge", "to_chrome", "render_tree", "main"]


def load_spans(paths: Iterable[str]) -> List[dict]:
    """Read span records (``"kind": "span"`` lines) from files and/or
    glob patterns. Unreadable files and non-JSON lines are skipped —
    a half-written final line from a SIGKILLed process must not sink
    the merge of everything else."""
    files: List[str] = []
    for p in paths:
        hits = sorted(glob_mod.glob(p))
        files.extend(hits if hits else [p])
    out: List[dict] = []
    for path in files:
        try:
            with open(path, encoding="utf-8") as f:
                lines = f.readlines()
        except OSError:
            continue
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # torn final line of a killed process
            if isinstance(rec, dict) and rec.get("kind") == "span":
                out.append(rec)
    return out


def merge(spans: List[dict]) -> dict:
    """Group spans by trace id and resolve parentage.

    Returns ``{"traces": {tid: {...}}, "orphans": total}`` where each
    trace carries ``spans`` (ts-ordered), ``roots`` (parentless span
    ids), ``orphans`` (spans whose parent id resolves to no span in
    the trace), ``pids``, and ``duration_s`` (root span span-width).
    Duplicate span ids (a retried emission) keep the first record."""
    traces: Dict[str, dict] = {}
    for s in spans:
        tid = s.get("trace")
        if not tid:
            continue
        t = traces.setdefault(tid, {"spans": [], "_ids": set()})
        sid = s.get("span")
        if sid in t["_ids"]:
            continue
        t["_ids"].add(sid)
        t["spans"].append(s)
    total_orphans = 0
    for tid, t in traces.items():
        ids = t.pop("_ids")
        t["spans"].sort(key=lambda s: s.get("ts", 0.0))
        roots = [s["span"] for s in t["spans"] if s.get("parent") is None]
        orphans = [
            s["span"] for s in t["spans"]
            if s.get("parent") is not None and s["parent"] not in ids
        ]
        t["roots"] = roots
        t["orphans"] = orphans
        t["pids"] = sorted({s.get("pid") for s in t["spans"]})
        root_spans = [s for s in t["spans"] if s.get("parent") is None]
        t["duration_s"] = max(
            (s.get("dur_us", 0.0) / 1e6 for s in root_spans), default=0.0
        )
        total_orphans += len(orphans)
    return {"traces": traces, "orphans": total_orphans}


def to_chrome(merged: dict) -> dict:
    """Chrome trace-event JSON (Perfetto-loadable): one complete event
    per span, real pid/tid tracks, annotations as ``args``."""
    events = []
    for tid, t in sorted(merged["traces"].items()):
        for s in t["spans"]:
            events.append({
                "ph": "X",
                "name": s.get("name"),
                "cat": f"trace:{tid}",
                "ts": round(s.get("ts", 0.0) * 1e6, 1),
                "dur": s.get("dur_us", 0.0),
                "pid": s.get("pid", 0),
                "tid": s.get("tid", 0),
                "args": {
                    "trace": tid,
                    "span": s.get("span"),
                    "parent": s.get("parent"),
                    "status": s.get("status", "ok"),
                    **(s.get("annotations") or {}),
                },
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def render_tree(merged: dict, only: Optional[str] = None) -> str:
    """Human rendering: one indented tree per trace (cross-process —
    a child span from another pid nests under its wire parent)."""
    from ..utils import trace_sink

    lines: List[str] = []
    for tid, t in sorted(merged["traces"].items()):
        if only is not None and tid != only:
            continue
        root = next(
            (s for s in t["spans"] if s.get("parent") is None), None
        )
        lines.append(trace_sink.render_trace({
            "trace": tid,
            "name": root.get("name") if root else "(no root span)",
            "status": root.get("status", "?") if root else "?",
            "duration_s": t["duration_s"],
            "spans": t["spans"],
        }))
        if t["orphans"]:
            lines.append(f"  !! {len(t['orphans'])} orphan span(s): "
                         + ", ".join(t["orphans"][:5]))
        lines.append("")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m spark_rapids_jni_tpu_torch.analysis.tracemerge",
        description="join per-process srjt-trace span logs into "
                    "per-trace trees")
    ap.add_argument("paths", nargs="+",
                    help="span-log files or glob patterns "
                    "(e.g. 'artifacts/trace_spans*.jsonl')")
    ap.add_argument("--format", default="chrome",
                    choices=("chrome", "json", "tree"),
                    help="chrome = Perfetto-loadable trace-event JSON "
                    "(default); json = the merged structure the gates "
                    "read; tree = human span trees")
    ap.add_argument("--out", default=None,
                    help="write the output here instead of stdout")
    ap.add_argument("--trace", default=None,
                    help="restrict tree output to one trace id")
    ap.add_argument("--gate-orphans", action="store_true",
                    help="exit 1 when any span's parent does not "
                    "resolve within its trace")
    args = ap.parse_args(argv)
    spans = load_spans(args.paths)
    merged = merge(spans)
    if args.format == "chrome":
        body = json.dumps(to_chrome(merged), indent=1)
    elif args.format == "json":
        # merge() already popped its working keys: the structure is
        # the public shape as-is
        body = json.dumps(merged, indent=1)
    else:
        body = render_tree(merged, only=args.trace)
    if args.out:
        d = os.path.dirname(args.out)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(body + "\n")
    else:
        print(body)
    n_traces = len(merged["traces"])
    print(
        f"tracemerge: {len(spans)} spans across {n_traces} trace(s), "
        f"{merged['orphans']} orphan(s)"
        + (f" -> {args.out}" if args.out else ""),
        file=sys.stderr,
    )
    if args.gate_orphans and merged["orphans"]:
        print("tracemerge: orphan spans present (parent does not "
              "resolve within its trace) — propagation bug", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
