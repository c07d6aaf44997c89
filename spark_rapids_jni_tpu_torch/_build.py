"""Kernel builder: nvcc into shared libraries with a plain C interface,
loaded with ctypes.

Each source under ``csrc/`` becomes one library under
``build/torch_kernels/`` at the root of the checkout, named by the hash
of its source and the shared headers (``csrc/*.cuh``), so an edited
source rebuilds and an unchanged one is reused. Nothing is built when a module is imported: ``library`` builds
on the first launch of one of its kernels, and ``build_all`` starts
every missing build at once (one nvcc per source) for callers that want
the build out of the way first.

Every C entry point of a CUDA library returns ``cudaGetLastError()`` as
an int; ``check`` raises when it is not 0.

Host libraries (``HOST_SOURCES``) build the same way with the host C++
compiler (``$CXX``, else ``c++``, ``g++`` or ``clang++``): ``codecs``
is ``csrc/codecs.cc`` over the repo's own decoders in ``native/src``,
linked with the system libzstd when ``zstd_probe`` finds its header and
library, and without zstd otherwise (``zstd_probe`` keeps the compiler's
message for the error a zstd page then raises).
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
from typing import Dict, Tuple

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
NATIVE_SRC = _PKG.parent / "native" / "src"
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
            "rows_to_planes_launch": [_P, _I, _P, _I, _I, _I, _P, _P],
        },
    ),
    "groupby": (
        "groupby.cu",
        {
            "groupby_sum_outer_launch": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _P],
            "groupby_sum_bounded_launch": [_P, _I, _P, _P, _P, _I, _I, _I, _P],
        },
    ),
    "strings": (
        "strings.cu",
        {
            "rotl_take_launch": [_P, _P, _P, _I, _I, _I, _P],
            "var_accumulate_launch": [_P, _P, _I, _P, _I, _I, _I, _I, _P],
            "asm_epilogue_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
            "ragged_compact_launch": [_P, _P, _I, _I, _P, _I, _I, _P],
            "assemble_rows_launch": [_P, _I, _P, _I, _P, _I, _P],
            "extract_strings_launch": [_P, _P, _I, _I, _I, _I, _P],
        },
    ),
    "partition": (
        "partition.cu",
        {"partition_map_launch": [_P, _I, _P, _P, _I, _I, _I, _P]},
    ),
    "join": (
        "join.cu",
        {"probe_paged_launch": [_P, _I, _I, _P, _P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _P, _P,
                                _P]},
    ),
}

# host C++ library name -> (source under csrc/, sources under native/src,
# {C function: (argument ctypes, result ctype)})
_CP = ctypes.c_char_p
HOST_SOURCES: Dict[str, tuple] = {
    "codecs": (
        "codecs.cc",
        ("snappy.cc", "lz4.cc", "lzo.cc"),
        {
            "codecs_last_error": ([], _CP),
            "codecs_has_zstd": ([], _I),
            "codecs_snappy_length": ([_P, _I], _I),
            "codecs_snappy": ([_P, _I, _P, _I], _I),
            "codecs_lz4_block": ([_P, _I, _P, _I], _I),
            "codecs_lzo1x": ([_P, _I, _P, _I], _I),
            "codecs_zstd": ([_P, _I, _P, _I], _I),
            "codecs_zstd_content_size": ([_P, _I], _I),
            "codecs_byte_array_lens": ([_P, _I, _P, _I], _I),
        },
    ),
}
CXX_FLAGS = ["-std=c++17", "-O2", "-shared", "-fPIC", "-fvisibility=hidden"]
_ZSTD_FLAGS = ["-DCODECS_HAVE_ZSTD"]

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


def _cxx() -> str:
    for cand in (os.environ.get("CXX"), "c++", "g++", "clang++"):
        found = shutil.which(cand) if cand else None
        if found:
            return found
    raise RuntimeError("no host C++ compiler (c++, g++ or clang++) found: the codec library "
                       "builds from native/src with one")


_ZSTD_PROBE = "#include <zstd.h>\nint main() { return ZSTD_versionNumber() > 0 ? 0 : 1; }\n"


@functools.lru_cache(maxsize=None)
def zstd_probe() -> Tuple[bool, str]:
    """(whether the host compiler finds zstd.h and links -lzstd, its
    output when it does not). Asked once a process."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"zstd_probe.{os.getpid()}"
    res = subprocess.run([_cxx(), "-x", "c++", "-", "-o", str(out), "-lzstd"], input=_ZSTD_PROBE,
                         capture_output=True, text=True)
    out.unlink(missing_ok=True)
    return res.returncode == 0, (res.stdout + res.stderr).strip()


def _host_inputs(name: str):
    """(the sources, the flags) of host library ``name``."""
    src, native, _ = HOST_SOURCES[name]
    srcs = [CSRC / src] + [NATIVE_SRC / n for n in native]
    flags = list(CXX_FLAGS) + [f"-I{NATIVE_SRC}"]
    if name == "codecs" and zstd_probe()[0]:
        srcs.append(NATIVE_SRC / "zstd_codec.cc")
        flags += _ZSTD_FLAGS
    return srcs, flags


def lib_path(name: str) -> Path:
    """The library's file, named by the hash of its sources, the headers
    they include (``csrc/*.cuh``; ``native/src/*.h`` for a host library)
    and the flags."""
    if name in HOST_SOURCES:
        srcs, flags = _host_inputs(name)
        headers = sorted(NATIVE_SRC.glob("*.h"))
    else:
        srcs, flags = [CSRC / SOURCES[name][0]], NVCC_FLAGS
        headers = sorted(CSRC.glob("*.cuh"))
    blob = b"".join(f.read_bytes() for f in srcs + headers) + " ".join(flags).encode()
    return BUILD_DIR / f"lib{name}-{hashlib.sha1(blob).hexdigest()[:12]}.so"


def _start_build(name: str):
    """Start the compiler for one library (None when it is already built)."""
    out = lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if name in HOST_SOURCES:
        srcs, flags = _host_inputs(name)
        cmd = [_cxx(), *flags, "-o", str(tmp), *map(str, srcs)]
        if "-DCODECS_HAVE_ZSTD" in flags:
            cmd.append("-lzstd")
    else:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name][0])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        src = (HOST_SOURCES.get(name) or SOURCES[name])[0]
        raise RuntimeError(f"the build of {src} failed (rc {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent builder sees a whole file


# the native runtime's sources: the object library of native/CMakeLists.txt
NATIVE_RUNTIME_SOURCES = (
    "thrift_compact.cc", "parquet_footer.cc", "host_buffer.cc", "snappy.cc", "lz4.cc",
    "lzo.cc", "zstd_codec.cc", "columnar.cc", "sidecar.cc", "decimal128.cc",
    "faultinj.cc", "c_api.cc",
)


def _native_runtime_inputs():
    """(the sources, whether -lzstd links) of the port's libsrjt.so build:
    native/src's, with ``csrc/zstd_absent.cc`` in place of zstd_codec.cc
    where ``zstd_probe`` finds no zstd.h."""
    srcs = [NATIVE_SRC / n for n in NATIVE_RUNTIME_SOURCES]
    zstd = zstd_probe()[0]
    if not zstd:
        srcs[NATIVE_RUNTIME_SOURCES.index("zstd_codec.cc")] = CSRC / "zstd_absent.cc"
    return srcs, zstd


def native_runtime_path() -> Path:
    """Where the port's own build of ``libsrjt.so`` goes, named by the hash
    of its sources, native/src's headers and the flags."""
    srcs, zstd = _native_runtime_inputs()
    blob = b"".join(f.read_bytes() for f in srcs + sorted(NATIVE_SRC.glob("*.h")))
    blob += (" ".join(CXX_FLAGS) + (" -lzstd" if zstd else "")).encode()
    return BUILD_DIR / f"libsrjt-{hashlib.sha1(blob).hexdigest()[:12]}.so"


def build_native_runtime() -> Path:
    """Compile native/src (read, never edited) into ``libsrjt.so`` with the
    host C++ compiler, linked with -lzstd where the host has it, into the
    git-ignored build directory; the sources compile in parallel. Returns
    the library's path; raises RuntimeError with the compiler's output on
    failure."""
    out = native_runtime_path()
    with _lock:
        if out.exists():
            return out
        srcs, zstd = _native_runtime_inputs()
        objdir = BUILD_DIR / f"{out.stem}.{os.getpid()}.objs"
        objdir.mkdir(parents=True, exist_ok=True)
        flags = [f for f in CXX_FLAGS if f != "-shared"] + [f"-I{NATIVE_SRC}", "-pthread"]
        procs = []
        for src in srcs:
            obj = objdir / (src.name + ".o")
            cmd = [_cxx(), *flags, "-c", "-o", str(obj), str(src)]
            procs.append((src.name, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                          stderr=subprocess.STDOUT, text=True)))
        errors = []
        for n, _obj, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{n} (rc {proc.returncode}):\n{log}")
        if not errors:
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_cxx(), "-shared", "-pthread", "-o", str(tmp),
                   *(str(o) for _n, o, _p in procs), *(["-lzstd"] if zstd else [])]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                errors.append(f"link (rc {res.returncode}):\n{res.stdout}{res.stderr}")
            else:
                os.replace(tmp, out)
        shutil.rmtree(objdir, ignore_errors=True)
        if errors:
            raise RuntimeError("the build of libsrjt.so from native/src failed: "
                               + "\n".join(errors))
        return out


def build_all() -> None:
    """Build every missing library, CUDA and host, all compilers at once."""
    with _lock:
        started = {name: _start_build(name) for name in [*SOURCES, *HOST_SOURCES]}
        for name, st in started.items():
            _finish_build(name, st)


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (CUDA or host), built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        _finish_build(name, _start_build(name))
        lib = ctypes.CDLL(str(lib_path(name)))
        if name in HOST_SOURCES:
            fns = HOST_SOURCES[name][2]
        else:
            fns = {fn: (argtypes, ctypes.c_int) for fn, argtypes in SOURCES[name][1].items()}
        for fn, (argtypes, restype) in fns.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = restype
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
