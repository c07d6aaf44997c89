"""Shared fixtures of the benchmark's own tests.

``card`` marks a test that needs a CUDA device; the ``card`` fixture
decides inside the test whether there is one and skips it where there is
none. ``small_cell`` resolves a cell of ``BENCHMARK.json`` and cuts its
rows to a size a CPU test holds.
"""

import json

import pytest
import torch

from portbench import harness


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="session")
def bench():
    return json.loads((harness.ROOT / "BENCHMARK.json").read_text())


SMALL_ROWS = {"rowconv_fixed212": 3001, "tpch_sf1": 20000}


@pytest.fixture
def small_cell(bench):
    def make(name: str) -> dict:
        cell = harness.resolve(bench, name)
        cell["cfg"]["rows"] = SMALL_ROWS[name.split(".")[0]]
        return cell
    return make
