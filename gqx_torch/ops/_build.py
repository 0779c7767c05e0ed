"""Build the port's CUDA kernels with nvcc, and its host library with g++,
and load them with ctypes.

Each ``gqx_torch/csrc/<name>.cu`` has a plain C interface and compiles in
seconds into its own shared library under ``gqx_torch/_build/`` (listed in
.gitignore), at first use.  A library's file name carries a hash of its
source, of the headers beside it (``csrc/*.cuh``) and of the flags, so an
edited source is rebuilt.  ``build()`` starts one nvcc per source, all at
once.

``load_host`` builds a host source, ``csrc/<name>.cc`` (the data
pipeline's ``gqx_native.cc``), with g++ and gqx's flags for its native
library (``native/Makefile``), into the same directory under the same
naming rule; it needs no CUDA toolkit, so it builds on a CPU-only host.

Every C entry takes its pointers and the CUDA stream as ``void*`` and
returns ``cudaGetLastError()`` after its launch; ``check`` raises on a
nonzero code, since a refused launch never runs and no later synchronise
reports it.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
SOURCES = ("hsq_encode", "hsq_decode_mean", "philox_uniform",
           "hsq_decode", "hsq_rows_encode", "hsq_rows_encode_tc", "hsq_rows_encode_wide",
           "hsq_rows_decode", "per_user_dw",
           "per_user_dw_tc", "per_user_dw_narrow", "per_user_dw_tc_f32", "per_user_dw_narrow_f32",
           "grouped_bn")

#: gqx's flags for its native library (native/Makefile), so that the host
#: library computes gqx's bits
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-fopenmp", "-shared")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return path


def _library_path(name: str, flags: Sequence[str], sources: Sequence[str]) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for path in sources:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def _target(name: str):
    src = os.path.join(CSRC_DIR, name + ".cu")
    headers = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    return src, _library_path(name, NVCC_FLAGS, [src] + headers)


def build(names: Sequence[str] = SOURCES) -> float:
    """Compile the named sources that are not built yet, one nvcc process
    each, all started together.  Returns the wall time in seconds."""
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = []
    for name in names:
        src, lib = _target(name)
        if os.path.exists(lib):
            continue
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
        jobs.append((name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for name, lib, tmp, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{out.decode(errors='replace')}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _, path = _target(name)
            if not os.path.exists(path):
                build((name,))
            lib = ctypes.CDLL(path)
            lib.gqx_error_string.argtypes = [ctypes.c_int]
            lib.gqx_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
    return lib


def load_host(name: str) -> ctypes.CDLL:
    """The loaded host library for ``csrc/<name>.cc``, built first with the
    g++ on PATH if needed (not ``$CXX``, which may name a compiler without
    OpenMP).  Raises ``RuntimeError`` where the compiler fails and
    ``OSError`` where it is missing."""
    key = name + ".cc"
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            src = os.path.join(CSRC_DIR, name + ".cc")
            path = _library_path(name, CXX_FLAGS, [src])
            if not os.path.exists(path):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{path}.{os.getpid()}.tmp"
                cmd = ["g++", *CXX_FLAGS, "-o", tmp, src]
                out = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     timeout=300)
                if out.returncode != 0:
                    raise RuntimeError(f"{cmd[0]} failed for {name}.cc:\n"
                                       f"{out.stdout.decode(errors='replace')}")
                os.replace(tmp, path)
            lib = _libs[key] = ctypes.CDLL(path)
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.gqx_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
