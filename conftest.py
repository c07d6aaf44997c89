"""Test harness: the native library built before any test process starts,
and one torch intra-op thread per test process.

Native build: the native tests (and the runtime, sidecar and reader
tests that use ``libsrjt.so``) find the library at collection and skip
without it, so a run from a fresh checkout would count fewer passes than
one from a tree that happened to hold an earlier build. When ``cmake``
and ``ninja`` are on ``PATH``, the controlling process runs the
documented build (``cmake -S native -B native/build -G Ninja`` when the
build directory is not configured, then ``ninja -C native/build``, which
does nothing on an up-to-date tree) in ``pytest_configure``: before any
xdist worker starts, so no test process is loading the library while
``ninja`` writes it. A failed build is printed with the tool's last
lines, on the terminal and in the report header; the native tests then
skip for their own reasons.

Threads: the port's tests (``tests/test_torch_*.py``) run small CPU
tensors in pytest-xdist workers that share the host's cores with each
other and with XLA's own threads. torch's default, one intra-op thread
per core in every worker, oversubscribes the host and slows every
worker, while tensors of a few thousand rows gain nothing from a thread
pool. The checks themselves are the same either way.
"""

import os
import shutil
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

_NATIVE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native")
_BUILD = os.path.join(_NATIVE, "build")
_BUILD_FAILURE = pytest.StashKey[list]()


def _build_native() -> list:
    """Run the native build; returns the failed step's last lines, or []
    when it succeeded or there is no toolchain to run it."""
    if shutil.which("cmake") is None or shutil.which("ninja") is None:
        return []
    steps = [["ninja", "-C", _BUILD]]
    if not os.path.exists(os.path.join(_BUILD, "build.ninja")):
        steps.insert(0, ["cmake", "-S", _NATIVE, "-B", _BUILD, "-G", "Ninja"])
    for cmd in steps:
        try:
            r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        except subprocess.TimeoutExpired:
            return [f"native build: `{' '.join(cmd)}` ran past 600 s"]
        if r.returncode != 0:
            tail = (r.stdout + r.stderr).splitlines()[-20:]
            return [f"native build: `{' '.join(cmd)}` exited {r.returncode}:"] + tail
    return []


def pytest_configure(config):
    if hasattr(config, "workerinput"):
        return  # an xdist worker: the controlling process built before it started
    failure = _build_native()
    config.stash[_BUILD_FAILURE] = failure
    if failure:
        print("\n".join(failure), file=sys.stderr, flush=True)


def pytest_report_header(config):
    return config.stash.get(_BUILD_FAILURE, [])
