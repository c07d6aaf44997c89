"""The form of a run's last lines: the result's JSON object last on
standard output, ``checks`` its last key; each number compared beside
its limit last on standard error."""

import json
import time

import torch

from portbench import harness


def test_result_line(small_cell, capsys):
    cell = small_cell("tpch_sf1.q1")
    res = harness.run_cell(cell, 2**31 + 3, 0.2, False, torch.device("cpu"), time.perf_counter())
    capsys.readouterr()
    harness._print_result(res)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    for m in cell["end_to_end"]:
        assert line["metrics"][m["name"]]["unit"] == m["unit"]
        assert line["metrics"][m["name"]]["value"] >= 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    tail = err.strip().splitlines()
    assert tail[-1] == "correct: True"
    assert [t.split(":")[0] for t in tail[:-1]] == [f"check {k}" for k in line["checks"]]


def test_a_failed_check_reads_false(small_cell):
    cell = small_cell("rowconv_fixed212.decode")
    cell["limits"] = dict(cell["limits"], sum_gap=-1.0)  # under any reading
    res = harness.run_cell(cell, 5, 0.2, False, torch.device("cpu"), time.perf_counter())
    assert res["correct"] is False
    assert res["checks"]["sum_gap"]["value"] >= 0.0
