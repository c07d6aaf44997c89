"""Port: the PyTorch package stands alone. It imports neither jax nor the
JAX package (checked in a fresh interpreter, by whole module name, since
``spark_rapids_jni_tpu_torch`` itself starts with ``spark_rapids_jni_tpu``),
``chip_smoke.py`` imports neither (checked by an AST scan), entry points
without a device raise when there is no card, and importing the kernel
modules needs no CUDA compiler."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PKG = "spark_rapids_jni_tpu_torch"


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.") or name == "jaxlib"
            or name.startswith("jaxlib.") or name == "spark_rapids_jni_tpu"
            or name.startswith("spark_rapids_jni_tpu."))


def _port_modules():
    mods = []
    for path in sorted((REPO / PKG).rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def _run(code: str, **env):
    full = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    full["PYTHONPATH"] = str(REPO)
    full.update(env)
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=full,
                          capture_output=True, text=True, timeout=120)


def test_forbidden_matches_whole_names():
    assert _forbidden("jax") and _forbidden("jax.numpy") and _forbidden("spark_rapids_jni_tpu.ops")
    assert not _forbidden(PKG) and not _forbidden(PKG + ".ops") and not _forbidden("jaxtyping")


def test_port_imports_no_jax():
    mods = _port_modules()
    assert f"{PKG}.ops.row_conversion" in mods and f"{PKG}._build" in mods
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    res = _run(code)
    assert res.returncode == 0, res.stderr
    loaded = json.loads(res.stdout.strip().splitlines()[-1])
    assert set(mods) <= set(loaded)
    assert [m for m in loaded if _forbidden(m)] == []


@pytest.mark.parametrize("mod", ["ops.murmur", "ops.hashing", "ops.bitutils", "ops.sort",
                                 "ops.copying", "ops.paged_join", "ops.join",
                                 "parallel.shuffle", "ops.f64acc", "ops.expressions",
                                 "ops.aggregate", "pipeline", "models", "models.datagen",
                                 "models.tpch", "models.compiled"])
def test_join_path_modules_are_walked(mod):
    # the walk above covers these by name; a module missing from the
    # package fails here rather than silently leaving the scan
    assert f"{PKG}.{mod}" in _port_modules()


@pytest.mark.parametrize("mod", ["columnar.frames", "utils", "utils.errors", "utils.integrity",
                                 "io", "io.thrift_compact", "io.parquet_footer", "io.codecs",
                                 "io.parquet_reader", "io.orc_reader"])
def test_io_modules_are_walked(mod):
    assert f"{PKG}.{mod}" in _port_modules()


@pytest.mark.parametrize("mod", ["utils.knobs", "utils.metrics", "utils.deadline",
                                 "utils.trace_sink", "utils.tracing", "utils.faultinj",
                                 "utils.retry", "utils.dispatch", "utils.memory"])
def test_runtime_core_modules_are_walked(mod):
    assert f"{PKG}.{mod}" in _port_modules()


@pytest.mark.parametrize("mod", ["sidecar", "sidecar_pool", "runtime", "serve", "serve.journal",
                                 "serve.scheduler"])
def test_serving_tier_modules_are_walked(mod):
    assert f"{PKG}.{mod}" in _port_modules()


@pytest.mark.parametrize("mod", ["plan", "plan.exprs", "plan.nodes", "plan.rewrites",
                                 "plan.verifier", "plan.optimizer", "plan.distribute",
                                 "plan.compiler", "plan.stats", "plan.stats.sketches",
                                 "plan.stats.model", "cache", "cache.tablegen",
                                 "models.tpcds_plans"])
def test_plan_tier_modules_are_walked(mod):
    assert f"{PKG}.{mod}" in _port_modules()


@pytest.mark.parametrize("mod", ["analysis", "analysis.lint", "analysis.races",
                                 "analysis.lockdep", "analysis.tracemerge",
                                 "analysis.planfuzz", "analysis.plancheck"])
def test_analysis_modules_are_walked(mod):
    assert f"{PKG}.{mod}" in _port_modules()


def _environ_knob_reads(path: Path):
    """Lines that read ``os.environ`` / ``os.getenv`` with a port-knob key
    or with a key that is not a string literal."""
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        key = None
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            f = node.func
            env_get = (f.attr == "get" and isinstance(f.value, ast.Attribute)
                       and f.value.attr == "environ")
            if env_get or f.attr == "getenv":
                key = node.args[0] if node.args else None
            else:
                continue
        elif (isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Load)
              and isinstance(node.value, ast.Attribute) and node.value.attr == "environ"):
            key = node.slice
        else:
            continue
        if not (isinstance(key, ast.Constant) and isinstance(key.value, str)
                and not key.value.startswith("SRJTORCH_")):
            out.append(node.lineno)
    return out


def test_only_the_bootstrap_reads_knobs_outside_the_registry():
    hits = {}
    for path in sorted((REPO / PKG).rglob("*.py")):
        rel = str(path.relative_to(REPO / PKG))
        lines = _environ_knob_reads(path)
        if lines and rel != "utils/knobs.py":
            hits[rel] = lines
    assert list(hits) == ["__init__.py"] and len(hits["__init__.py"]) == 2
    boot = (REPO / PKG / "__init__.py").read_text()
    assert boot.count("srjt-lint: allow-environ(") == 2
    # the bootstrap arms lockdep before any other statement of the package
    body = ast.parse(boot).body
    assert isinstance(body[0], ast.Expr) and isinstance(body[2], ast.If)
    assert [(a.name, a.asname) for a in body[1].names] == [("os", "_os")]


def test_bootstrap_arms_lockdep_before_any_package_lock(tmp_path):
    code = (
        "import threading\n"
        f"import {PKG} as p, {PKG}.utils.metrics as m\n"
        f"from {PKG}.memgov.catalog import BufferCatalog\n"
        f"from {PKG}.analysis import lockdep\n"
        "print(lockdep.is_installed(), lockdep.race_armed(), type(m.registry()._metrics).__name__,\n"
        "      type(BufferCatalog()._lock).__name__)\n"
        "lockdep.uninstall()\n"
    )
    res = _run(code, SRJTORCH_RACE="1", SRJTORCH_LOCKDEP_DIR=str(tmp_path / "ld"))
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["True", "True", "_TrackedDict", "_TrackedLock"]
    res = _run(code.replace("lockdep.uninstall()\n", ""))
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["False", "False", "dict", "RLock"]


def test_plan_generators_raise_without_a_card(monkeypatch):
    from spark_rapids_jni_tpu_torch.models import tpcds_plans

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for gen in (tpcds_plans.gen_store_returns, tpcds_plans.gen_catalog,
                tpcds_plans.gen_channels):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            gen(8)
        assert all(t.columns[0].device.type == "cpu" for t in gen(8, device="cpu").values())


def test_port_adds_no_knob_literal():
    # the reference's knobs are SRJT_*: the port reads no environment knob
    # of that prefix, in its Python or its C++
    hits = [str(p.relative_to(REPO)) for p in sorted((REPO / PKG).rglob("*"))
            if p.suffix in (".py", ".cu", ".cuh", ".cc", ".h") and "SRJT_" in p.read_text()]
    assert hits == []
    assert "SRJT_" not in (REPO / "chip_smoke.py").read_text()
    assert "SRJT_" not in (REPO / "tests" / "torch_io_writers.py").read_text()


def test_io_entry_points_raise_without_a_card(monkeypatch):
    from spark_rapids_jni_tpu_torch.columnar import Column, Table
    from spark_rapids_jni_tpu_torch.columnar import frames
    from spark_rapids_jni_tpu_torch.io import orc_reader, parquet_reader

    kid = Column.from_numpy(np.arange(3, dtype=np.int32), device="cpu")
    buf = frames.encode_table(Table([kid]))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        frames.decode_table(buf)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        parquet_reader.read_table(b"PAR1....PAR1")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        orc_reader.read_table(b"ORC....")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Column.list_from_parts(np.array([0, 1, 3]), kid)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Column.struct_from_parts([kid], ["a"], validity=np.ones(3, bool))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Column.strings_from_parts(np.array([0, 1]), np.array([97], np.uint8))
    # tensor parts stay where they are: no device is asked for
    assert Column.struct_from_parts([kid], ["a"]).device.type == "cpu"


def test_chip_smoke_imports_no_jax():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            names += [a.value for a in node.args if isinstance(a, ast.Constant)]
    assert any(n.startswith(PKG) for n in names)
    assert [n for n in names if _forbidden(n)] == []


def test_entry_points_raise_without_a_card(monkeypatch):
    from spark_rapids_jni_tpu_torch.columnar import Column, Table
    from spark_rapids_jni_tpu_torch.interop import carry_table
    from spark_rapids_jni_tpu_torch.columnar import dtype as pdt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arr = np.arange(4, dtype=np.int32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Column.from_numpy(arr)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Table.from_numpy([arr])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        carry_table([arr], [pdt.INT32])
    from spark_rapids_jni_tpu_torch.models import datagen, tpch

    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpch.gen_lineitem(8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        datagen.create_random_table([pdt.INT32, pdt.FLOAT64], 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        datagen.create_random_column(pdt.INT32, 8, np.random.default_rng(0))
    # an explicit CPU device is honoured
    assert Column.from_numpy(arr, device="cpu").device.type == "cpu"
    assert tpch.gen_lineitem(8, device="cpu").columns[0].device.type == "cpu"


def test_kernel_modules_import_without_nvcc():
    code = (
        f"import {PKG}.ops.ragged_bytes, {PKG}.ops.hopper_kernels, {PKG}.ops.row_conversion\n"
        f"import {PKG}.ops.join, {PKG}.ops.hashing, {PKG}.parallel.shuffle\n"
        f"import {PKG}.pipeline, {PKG}.models\n"
        f"import {PKG}.io.codecs, {PKG}.io.parquet_reader, {PKG}.io.orc_reader\n"
        f"import {PKG}.columnar.frames\n"
        f"import {PKG}._build as b\n"
        "print(len(b._libs))\n"
    )
    res = _run(code, PATH="/nonexistent", CUDA_HOME="/nonexistent")
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "0"  # nothing was built or loaded at import


def test_build_flags_target_sm90a():
    from spark_rapids_jni_tpu_torch import _build

    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    for src, _ in _build.SOURCES.values():
        assert (_build.CSRC / src).exists()
    for src, native, _ in _build.HOST_SOURCES.values():
        assert (_build.CSRC / src).exists()
        assert all((_build.NATIVE_SRC / n).exists() for n in native)
