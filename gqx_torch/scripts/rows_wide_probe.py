"""Where the wide row-major encode's time goes, on the card.

    python -m gqx_torch.scripts.rows_wide_probe [--reps 10]

Builds ``gqx_torch/csrc/hsq_rows_encode_wide.cu`` (the encode for dims
above 32) with nvcc as it is and in variants made by replacing text of the
source, and times each by device time (torch.profiler) at P6's shape: 8
users x 91,904 rows of 256, K = 256 (the learned codebook), uint8 codes,
bf16 and float32 rows:

- ``kernel``: the kernel as it is (two accumulator sets);
- ``one set``: every pass into one set of accumulators (all the tensor
  cores' roundings at the scale of the whole sum);
- ``no u``: the recompute of u cut (codes only);
- ``no row copies``: the main loop's copies of the rows cut (the codebook
  chunks still copied; the products on stale rows): what staging the rows
  for each codeword tile costs.

For ``kernel`` and ``one set``, which compute the codes, the codes that
differ from the plain version and the largest top-2 margin |p| among them
(relative) are printed.  ``hsq_rows_encode.cu``, the CUDA-core kernel that
the route replaced, is timed beside them through its C entry
(``cuda_core_encode``).  Prints the card (nvidia-smi name and power limit)
and one line per variant and input type.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import tempfile

import numpy as np
import torch

from gqx_torch.codebooks import get_codebook
from gqx_torch.ops import _build, hsq_rows

SOURCE = "hsq_rows_encode_wide.cu"
VARIANTS = {
    "kernel": [],
    "one set": [("wgmma_128(s2, descriptor(", "wgmma_128(s1, descriptor(")],
    "no u": [("for (int c = 0; c < kS - 1; ++c) issue_u(c);", ""),
             ("for (int c = 0; c < chunks; ++c) {", "for (int c = 0; c < 0; ++c) {")],
    "no row copies": [("      load_rows<TIn, CP>(rows_s + buf * kRowsBytes, x, row0, rows, dim, "
                       "c * kChunk);\n", "")],
}
ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]


def cuda_core_encode(rows, codebook, code_dtype):
    """``hsq_rows_encode.cu``, the CUDA-core kernel that the wide route
    replaced (one row per thread, dim <= 256), through its C entry: for
    timing it beside that route and holding its u against the route's.
    Counts no launch (no path calls it)."""
    dim, k = rows.shape[-1], codebook.shape[0]
    if dim > 256 or not rows.is_contiguous():
        raise ValueError(f"hsq_rows_encode.cu: contiguous rows of dim <= 256, got {dim}")
    u = torch.empty(rows.shape[:-1], dtype=torch.float32, device=rows.device)
    codes = torch.empty(rows.shape[:-1], dtype=code_dtype, device=rows.device)
    lib = _build.load("hsq_rows_encode")
    fn = lib.gqx_hsq_rows_encode
    fn.argtypes, fn.restype = ARGTYPES + [ctypes.c_void_p], ctypes.c_int
    err = fn(rows.data_ptr(), int(rows.dtype == torch.bfloat16), codebook.data_ptr(), k, dim,
             u.numel(), u.data_ptr(), codes.data_ptr(), int(code_dtype == torch.uint8),
             _build.stream_ptr(rows.device))
    _build.check(lib, err, "hsq_rows_encode (hsq_rows_encode.cu)")
    return u, codes


def device_ms(fn, n: int) -> float:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
                if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA)
    if total == 0.0:
        raise RuntimeError("the profiler saw no device time")
    return total / 1e3 / n


def build(tmp: str):
    """{variant: loaded library}, one nvcc per variant, all started together."""
    with open(os.path.join(_build.CSRC_DIR, SOURCE)) as f:
        source = f.read()
    jobs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the text to replace is not in {SOURCE} once")
            text = text.replace(old, new)
        src, lib = os.path.join(tmp, f"v{i}.cu"), os.path.join(tmp, f"v{i}.so")
        with open(src, "w") as f:
            f.write(text)
        jobs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for name, (lib, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out.decode(errors='replace')}")
        libs[name] = ctypes.CDLL(lib)
    return libs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("rows_wide_probe: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {card}", flush=True)
    users, m, dim, k = 8, 91_904, 256, 256
    rng = np.random.default_rng(0)
    x32 = torch.from_numpy(rng.standard_normal((users, m, dim), dtype=np.float32)).cuda()
    x32 *= 1e-3
    cb = torch.from_numpy(get_codebook(dim, k)).cuda()
    u = torch.empty(users * m, device="cuda")
    codes = torch.empty(users * m, dtype=torch.uint8, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp)
        for x in (x32.bfloat16(), x32):
            label = str(x.dtype)[6:]
            _, c_plain = hsq_rows.hsq_encode_plain(x, cb, torch.uint8)
            for name, lib in libs.items():
                fn = lib.gqx_hsq_rows_encode_wide
                fn.argtypes, fn.restype = ARGTYPES + [ctypes.c_void_p] * 2, ctypes.c_int
                lib.gqx_hsq_rows_encode_wide_scratch_bytes.restype = ctypes.c_int64
                pieces = torch.empty(lib.gqx_hsq_rows_encode_wide_scratch_bytes(k, dim),
                                     dtype=torch.uint8, device="cuda")

                def call():
                    err = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), cb.data_ptr(), k, dim,
                             users * m, u.data_ptr(), codes.data_ptr(), 1, pieces.data_ptr(),
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")

                ms = device_ms(call, args.reps)
                extra = ""
                if name in ("kernel", "one set"):
                    call()
                    differ = (codes.view(users, m) != c_plain).reshape(-1)
                    worst = 0.0
                    if bool(differ.any()):
                        rows = x.reshape(-1, dim)[differ].double()
                        top = (rows @ cb.double().t()).abs().topk(2, dim=1).values
                        worst = float(((top[:, 0] - top[:, 1]) / top[:, 0]).max())
                    extra = (f"; {int(differ.sum())} codes differ from the plain version, "
                             f"top-2 margin up to {worst:.2e}")
                print(f"[rows_wide_probe] {name:<12s} {label:>8s}: {ms:.4f} ms{extra}", flush=True)
            ms = device_ms(lambda: cuda_core_encode(x, cb, torch.uint8), 2)
            print(f"[rows_wide_probe] {'cuda cores':<12s} {label:>8s}: {ms:.4f} ms "
                  "(hsq_rows_encode.cu)", flush=True)


if __name__ == "__main__":
    main()
