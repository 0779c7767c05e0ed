"""Where the row-major tensor-core encode's time goes, on the card.

    python -m gqx_torch.scripts.rows_encode_probe [--reps 10] [--baseline FILE.cu]

Builds ``gqx_torch/csrc/hsq_rows_encode_tc.cu`` with nvcc as it is and in
four variants made by replacing text of the source, and times each by
device time (torch.profiler) at P4's shape: 8 users x 2,940,928 rows of 8,
K = 1024, int32 codes, bf16 and float32 rows:

- ``kernel``: the kernel as it is;
- ``max``: the selection cut to the running maximum of |p| (its three
  FMNMX per 4 products and one more), without the compare and the
  predicated moves of the kept index and products;
- ``sum``: the selection replaced by a sum of the products: the loads, the
  staging, the mma and one read of every product;
- ``no mma``: the selection kept, the mma replaced by a few integer
  operations on the same A and B words;
- ``loads only``: both: the loads, the staging, the B fragments' reads and
  the loop.

Only ``kernel`` computes the encode; the variants' outputs are discarded.
``--baseline`` times another source on the float32 rows: one whose C entry
is ``gqx_hsq_rows_encode(x, codebook, k, dim, rows, u, codes, codes_u8,
stream)``, the CUDA-core kernel before it read bf16 rows, such as
``git show 9267967:gqx_torch/csrc/hsq_rows_encode.cu``.  Prints the card
(nvidia-smi name and power limit) and one line per variant.
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
from gqx_torch.ops import _build

# the selection's update in the pass over the codebook, and the products
SELECT = """            float v = fmaxf(fabsf(p[0][2 * h]), fabsf(p[0][2 * h + 1]));
#pragma unroll
            for (int q = 1; q < kGroup; ++q)
              v = fmaxf(v, fmaxf(fabsf(p[q][2 * h]), fabsf(p[q][2 * h + 1])));
            if (v > m[r][h]) {
              m[r][h] = v;
              jg[r][h] = j0 + jl;
#pragma unroll
              for (int i = 0; i < kKept; ++i) kept[r][h][i] = p[i >> 1][2 * h + (i & 1)];
            }"""
MAX_ONLY = SELECT[:SELECT.index("            if (v > m[r][h])")] + \
    "            m[r][h] = fmaxf(m[r][h], v);"
SUM_ONLY = """#pragma unroll
            for (int q = 0; q < kGroup; ++q) m[r][h] += p[q][2 * h] + p[q][2 * h + 1];"""
PRODUCTS = "          for (int q = 0; q < kGroup; ++q) products<N8, kX32>(p[q], xa[r], b[q]);"
NO_MMA = """          for (int q = 0; q < kGroup; ++q) {
            const unsigned w0 = xa[r][0][0][0] ^ b[q][0][0], w1 = xa[r][0][1][0] ^ b[q][2][0];
            p[q][0] = __uint_as_float(w0 & 0x3f7fffffu);
            p[q][1] = __uint_as_float((w0 >> 3) & 0x3f7fffffu);
            p[q][2] = __uint_as_float(w1 & 0x3f7fffffu);
            p[q][3] = __uint_as_float((w1 >> 3) & 0x3f7fffffu);
          }"""

VARIANTS = {
    "kernel": [],
    "max": [(SELECT, MAX_ONLY)],
    "sum": [(SELECT, SUM_ONLY)],
    "no mma": [(PRODUCTS, NO_MMA)],
    "loads only": [(SELECT, SUM_ONLY), (PRODUCTS, NO_MMA)],
}
ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
BASELINE_ARGTYPES = ARGTYPES[:1] + ARGTYPES[2:]     # no x_bf16


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


def build(tmp: str, baseline=None):
    """{variant: C entry}, one nvcc per variant, all started together."""
    with open(os.path.join(_build.CSRC_DIR, "hsq_rows_encode_tc.cu")) as f:
        source = f.read()
    sources = {}
    for name, edits in VARIANTS.items():
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the text to replace is not in "
                                   "hsq_rows_encode_tc.cu once")
            text = text.replace(old, new)
        sources[name] = (text, "gqx_hsq_rows_encode_tc")
    if baseline:
        with open(baseline) as f:
            sources["baseline"] = (f.read(), "gqx_hsq_rows_encode")
    jobs = {}
    for i, (name, (text, entry)) in enumerate(sources.items()):
        src, lib = os.path.join(tmp, f"v{i}.cu"), os.path.join(tmp, f"v{i}.so")
        with open(src, "w") as f:
            f.write(text)
        jobs[name] = (lib, entry, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    entries = {}
    for name, (lib, entry, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out.decode(errors='replace')}")
        entries[name] = getattr(ctypes.CDLL(lib), entry)
    return entries


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--baseline", default=None,
                    help="a .cu with the CUDA-core kernel's C entry, timed on float32 rows")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("rows_encode_probe: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {card}", flush=True)
    users, m, dim, k = 8, 2_940_928, 8, 1024
    rng = np.random.default_rng(0)
    x32 = torch.from_numpy(rng.standard_normal((users * m, dim), dtype=np.float32)).cuda()
    x32 *= 1e-3
    cb = torch.from_numpy(get_codebook(dim, k)).cuda()
    u = torch.empty(users * m, device="cuda")
    codes = torch.empty(users * m, dtype=torch.int32, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        entries = build(tmp, args.baseline)
        for name, fn in entries.items():
            old = name == "baseline"
            fn.argtypes, fn.restype = BASELINE_ARGTYPES if old else ARGTYPES, ctypes.c_int
            for x in ((x32,) if old else (x32.bfloat16(), x32)):
                def call():
                    bf16 = () if old else (int(x.dtype == torch.bfloat16),)
                    err = fn(x.data_ptr(), *bf16, cb.data_ptr(), k, dim, users * m, u.data_ptr(),
                             codes.data_ptr(), 0, torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")
                print(f"[rows_encode_probe] {name:<12s} {str(x.dtype)[6:]:>8s}: "
                      f"{device_ms(call, args.reps):.4f} ms", flush=True)


if __name__ == "__main__":
    main()
