"""Every cell of BENCHMARK.json resolves to its files by name, and a
cell added as files and one entry runs with no edit elsewhere."""

import json
import shutil
import time

import pytest
import torch

from portbench import harness


def test_every_cell_resolves(bench):
    assert bench["workloads"]
    for w in bench["workloads"]:
        cell = harness.resolve(bench, w["name"])
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        for key in ("dataset", "item"):
            assert cell[key].is_file(), cell[key]
        for path in cell["readers"].values():
            assert path.is_file(), path
        assert cell["limits"], w["name"]
        assert {m["name"] for m in cell["end_to_end"]} >= {"setup_s"}
        assert len(cell["end_to_end"]) >= 2 and cell["per_layer"], w["name"]


def test_config_files_are_the_configs(bench):
    for c in bench["configs"]:
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert any(w["config"] == c["name"] for w in bench["workloads"])


def test_every_metric_has_a_reader(bench):
    for m in bench["per_layer"]:
        assert (harness.BENCH_DIR / "layer_metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}


def test_cell_added_as_files_runs(tmp_path, bench):
    """A new configuration, mix and limits, and one workload entry."""
    for sub in ("configs", "mixes", "limits", "datasets", "items", "layer_metrics"):
        shutil.copytree(harness.BENCH_DIR / sub, tmp_path / sub)
    cfg = json.loads((tmp_path / "configs" / "rowconv_fixed212.json").read_text())
    cfg.update(name="rowconv_narrow", rows=2048, columns=16)
    (tmp_path / "configs" / "rowconv_narrow.json").write_text(json.dumps(cfg))
    mix = json.loads((tmp_path / "mixes" / "roundtrip.json").read_text())
    mix.update(sample_every=2)
    (tmp_path / "mixes" / "roundtrip_sampled.json").write_text(json.dumps(mix))
    shutil.copy(tmp_path / "limits" / "rowconv_fixed212.roundtrip.json",
                tmp_path / "limits" / "rowconv_narrow.roundtrip_sampled.json")
    added = dict(bench, workloads=bench["workloads"] + [
        {"name": "rowconv_narrow.roundtrip_sampled", "config": "rowconv_narrow",
         "traffic": "roundtrip_sampled", "chips": 1, "why": "a test cell"}])
    cell = harness.resolve(added, "rowconv_narrow.roundtrip_sampled", tmp_path)
    res = harness.run_cell(cell, 7, 0.3, False, torch.device("cpu"), time.perf_counter())
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {m["name"] for m in bench["end_to_end"]}


def test_unknown_cell_is_refused(bench):
    with pytest.raises(SystemExit):
        harness.resolve(bench, "no_such.cell")
