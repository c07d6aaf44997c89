"""Kernel builder: nvcc into shared libraries with a plain C interface,
loaded with ctypes.

Each source under ``csrc/`` becomes one library under
``build/torch_kernels/`` at the root of the checkout, named by the hash
of its source and the shared headers (``csrc/*.cuh``), so an edited
source rebuilds and an unchanged one is reused. Nothing is built when a module is imported: ``library`` builds
on the first launch of one of its kernels, and ``build_all`` starts
every missing build at once (one nvcc per source) for callers that want
the build out of the way first.

Every C entry point returns ``cudaGetLastError()`` as an int;
``check`` raises when it is not 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"

# library name -> (source file, {C function: argument ctypes})
_P = ctypes.c_void_p
_I = ctypes.c_int64
SOURCES: Dict[str, tuple] = {
    "planes": (
        "planes.cu",
        {
            "expand_u32_planes_launch": [_P, _P, _I, _I, _P],
            "pack_u8_planes_launch": [_P, _P, _I, _I, _P],
        },
    ),
    "groupby": (
        "groupby.cu",
        {
            "groupby_sum_outer_launch": [_P, _P, _P, _P, _I, _I, _I, _P],
            "groupby_sum_bounded_launch": [_P, _I, _P, _P, _P, _I, _I, _I, _P],
        },
    ),
    "strings": (
        "strings.cu",
        {
            "rotl_take_launch": [_P, _P, _P, _I, _I, _I, _P],
            "var_accumulate_launch": [_P, _P, _I, _P, _I, _I, _I, _I, _P],
            "asm_epilogue_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
            "ragged_compact_launch": [_P, _I, _P, _P, _I, _I, _P, _I, _I, _P],
        },
    ),
    "partition": (
        "partition.cu",
        {"partition_map_launch": [_P, _I, _P, _P, _I, _I, _I, _P]},
    ),
    "join": (
        "join.cu",
        {"probe_paged_launch": [_P, _I, _I, _P, _P, _P, _P, _I, _I, _P, _P, _I, _P]},
    ),
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def lib_path(name: str) -> Path:
    """The library's file, named by the hash of its source, the shared
    headers (``csrc/*.cuh``) and the flags."""
    src = CSRC / SOURCES[name][0]
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start_build(name: str):
    """Start nvcc for one library (None when it is already built)."""
    out = lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name][0])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCES[name][0]} (rc {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent builder sees a whole file


def build_all() -> None:
    """Build every missing library, all nvcc processes at once."""
    with _lock:
        started = {name: _start_build(name) for name in SOURCES}
        for name, st in started.items():
            _finish_build(name, st)


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        _finish_build(name, _start_build(name))
        lib = ctypes.CDLL(str(lib_path(name)))
        for fn, argtypes in SOURCES[name][1].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _libs[name] = lib
        return lib


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``, asked once."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def raw_stream(device) -> int:
    """The handle of ``device``'s current CUDA stream, without building a
    ``torch.cuda.Stream`` object (a few microseconds a call saved)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device.index)


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {rc}")
