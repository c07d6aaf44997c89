"""No module of the benchmark imports JAX or the JAX package (compared
by whole top-level name: the program's own name begins with the JAX
package's), the reference imports nothing of the program, and a run's
process loads neither."""

import ast
import subprocess
import sys

import pytest

from portbench import harness

FILES = sorted(p for p in harness.BENCH_DIR.rglob("*.py") if "tests" not in p.parts[-2:])


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(harness.BENCH_DIR)))
def test_no_jax(path):
    tops = {m.split(".", 1)[0] for m in _imports(path)}
    assert not tops & set(harness.FORBIDDEN), path


@pytest.mark.parametrize("path", sorted((harness.BENCH_DIR / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = {m.split(".", 1)[0] for m in _imports(path)}
    assert tops <= {"__future__", "dataclasses", "fractions", "typing", "numpy", "torch"}, tops


def test_a_run_loads_no_jax():
    code = ("import sys, time, torch; sys.path.insert(0, %r)\n"
            "from portbench import harness\n"
            "import json\n"
            "bench = json.loads((harness.ROOT / 'BENCHMARK.json').read_text())\n"
            "for w in bench['workloads']:\n"
            "    cell = harness.resolve(bench, w['name'])\n"
            "    cell['cfg']['rows'] = 2048\n"
            "    assert harness.run_cell(cell, 1, 0.05, False, torch.device('cpu'),"
            " time.perf_counter())['correct']\n"
            "print(harness.forbidden_modules())\n") % str(harness.ROOT)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                       cwd=harness.ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_whole():
    assert "spark_rapids_jni_tpu" in harness.FORBIDDEN
    assert harness.PROGRAM.split(".")[0] not in harness.FORBIDDEN
