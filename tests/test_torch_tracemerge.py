"""Port: ``analysis/tracemerge.py`` held against the JAX package's. The
reference's span-log fixtures (client and worker files, orphans, torn
lines, duplicates, globs) are merged by both packages: the same per-trace
trees, the same orphans, the same Chrome export and tree rendering, and
the same exit codes of the orphan gate."""

import json

import pytest

from spark_rapids_jni_tpu.analysis import tracemerge as RTM
from spark_rapids_jni_tpu_torch.analysis import tracemerge as PTM


def _span(trace, span, parent, name, ts=1.0, pid=1, **ann):
    rec = {"kind": "span", "trace": trace, "span": span, "parent": parent,
           "name": name, "ts": ts, "dur_us": 100.0, "pid": pid, "tid": 1, "status": "ok"}
    if ann:
        rec["annotations"] = ann
    return rec


def _write(path, recs, tail=""):
    with open(path, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
        f.write(tail)
    return str(path)


def _logs(tmp_path, case):
    if case == "cross_process":
        return [_write(tmp_path / "client.1.jsonl", [_span("t1", "r", None, "root", ts=1.0),
                                                      _span("t1", "c", "r", "request", ts=1.1)]),
                _write(tmp_path / "worker.2.jsonl",
                       [_span("t1", "w", "c", "worker_op", ts=1.2, pid=2)])]
    if case == "orphan":
        return [_write(tmp_path / "x.jsonl", [_span("t1", "r", None, "root"),
                                              _span("t1", "o", "missing", "stray")])]
    if case == "annotated":
        return [_write(tmp_path / "x.jsonl", [_span("t1", "r", None, "root", wid=3)])]
    if case == "torn_and_duplicate":
        return [_write(tmp_path / "x.jsonl", [_span("t1", "r", None, "root")] * 2,
                       tail='{"kind": "span", "trace": "t1", TORN')]
    if case == "glob":
        for i in range(3):
            _write(tmp_path / f"s.{i}.jsonl", [_span("t1", f"x{i}", None, f"n{i}")])
        return [str(tmp_path / "s.*.jsonl")]
    if case == "two_traces":
        return [_write(tmp_path / "a.1.jsonl", [_span("t2", "q", None, "query", ts=2.0),
                                                _span("t1", "r", None, "root", ts=1.0),
                                                _span("t2", "e", "q", "exchange.fetch", ts=2.5),
                                                _span("t1", "c", "r", "child", ts=1.1, pid=2)]),
                str(tmp_path / "missing.jsonl")]
    raise AssertionError(case)


CASES = ["cross_process", "orphan", "annotated", "torn_and_duplicate", "glob", "two_traces"]


@pytest.mark.parametrize("case", CASES)
def test_merge_and_exports_match_reference(tmp_path, case):
    paths = _logs(tmp_path, case)
    spans = PTM.load_spans(paths)
    assert spans == RTM.load_spans(paths)
    merged = PTM.merge(spans)
    assert merged == RTM.merge(RTM.load_spans(paths))
    assert PTM.to_chrome(merged) == RTM.to_chrome(merged)
    assert PTM.render_tree(merged) == RTM.render_tree(merged)
    if case == "cross_process":
        t = merged["traces"]["t1"]
        assert merged["orphans"] == 0 and t["pids"] == [1, 2] and t["roots"] == ["r"]
        assert [s["name"] for s in t["spans"]] == ["root", "request", "worker_op"]
    if case == "orphan":
        assert merged["orphans"] == 1 and merged["traces"]["t1"]["orphans"] == ["o"]
    if case == "torn_and_duplicate":
        assert len(merged["traces"]["t1"]["spans"]) == 1
    if case == "glob":
        assert len(spans) == 3
    if case == "two_traces":
        assert sorted(merged["traces"]) == ["t1", "t2"] and merged["orphans"] == 0


@pytest.mark.parametrize("case,fmt,gate", [
    ("orphan", "json", True), ("orphan", "json", False), ("annotated", "chrome", False),
    ("cross_process", "tree", True)])
def test_cli_matches_reference(tmp_path, capsys, case, fmt, gate):
    paths = _logs(tmp_path, case)
    outs, rcs = [], []
    for mod, name in ((RTM, "r"), (PTM, "p")):
        out = str(tmp_path / f"{name}.out")
        rcs.append(mod.main(paths + ["--format", fmt, "--out", out]
                            + (["--gate-orphans"] if gate else [])))
        outs.append(open(out).read())
    err = capsys.readouterr().err
    assert rcs[0] == rcs[1] and outs[0] == outs[1]
    assert rcs[1] == (1 if (gate and case == "orphan") else 0)
    assert err.count("tracemerge:") >= 2
    if fmt == "chrome":
        ev = json.loads(outs[1])["traceEvents"][0]
        assert ev["ph"] == "X" and ev["args"]["wid"] == 3 and ev["dur"] == 100.0


def test_port_span_log_merges_into_one_tree(tmp_path, monkeypatch):
    """The port's own sink writes <base>.<pid>.jsonl; nested spans of one
    traced op merge into one tree with no orphan."""
    from spark_rapids_jni_tpu_torch.utils import trace_sink, tracing

    base = str(tmp_path / "spans.jsonl")
    trace_sink.set_log_path(base)
    try:
        with tracing.enabled():
            with tracing.op_span("outer"):
                with tracing.span("inner"):
                    with tracing.span("leaf"):
                        pass
    finally:
        trace_sink.set_log_path(None)
    merged = PTM.merge(PTM.load_spans([str(tmp_path / "spans.*.jsonl")]))
    assert merged["orphans"] == 0 and len(merged["traces"]) == 1
    (t,) = merged["traces"].values()
    assert sorted(s["name"] for s in t["spans"]) == ["inner", "leaf", "op.outer"]
    assert len(t["roots"]) == 1 and "op.outer" in PTM.render_tree(merged)
