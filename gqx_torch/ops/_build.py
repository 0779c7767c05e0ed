"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``gqx_torch/csrc/<name>.cu`` has a plain C interface and compiles in
seconds into its own shared library under ``gqx_torch/_build/`` (listed in
.gitignore), at first use.  A library's file name carries a hash of its
source and flags, so an edited source is rebuilt.  ``build()`` starts one
nvcc per source, all at once.

Every C entry takes its pointers and the CUDA stream as ``void*`` and
returns ``cudaGetLastError()`` after its launch; ``check`` raises on a
nonzero code, since a refused launch never runs and no later synchronise
reports it.
"""

from __future__ import annotations

import ctypes
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
SOURCES = ("hsq_encode", "hsq_decode_mean", "philox_uniform")

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


def _target(name: str):
    src = os.path.join(CSRC_DIR, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, os.path.join(BUILD_DIR, f"{name}-{digest}.so")


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


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.gqx_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
