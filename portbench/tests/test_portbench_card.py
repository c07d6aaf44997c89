"""On the card: every cell runs and is correct on a short window, and
the control fails at the cell's own size. Skips without a card."""

import json
import subprocess
import sys

import pytest

from portbench import harness

pytestmark = pytest.mark.card


@pytest.mark.parametrize("name", ["rowconv_fixed212.roundtrip", "tpch_sf1.q1",
                                  "rowconv_fixed212.decode"])
def test_cell_runs_correct(card, name):
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload", name, "--seed",
                        "2147483999", "--seconds", "2", "--trace", "0"],
                       cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    assert json.loads(r.stdout.strip().splitlines()[-1])["correct"] is True


@pytest.mark.parametrize("name", ["rowconv_fixed212.roundtrip", "tpch_sf1.q1",
                                  "rowconv_fixed212.decode"])
def test_control_fails_at_cell_size(card, name):
    r = subprocess.run([sys.executable, "portbench/readings.py", "--workload", name, "--seeds",
                        "11,12,13", "--side", "control"],
                       cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [json.loads(x) for x in r.stdout.strip().splitlines()]
    limits = lines[-1]["limits"]
    for seed in lines[:-1]:
        assert any(v > limits[k] for k, v in seed["readings"].items()), seed
