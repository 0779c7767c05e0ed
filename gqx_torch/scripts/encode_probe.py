"""Where the HSQ encode kernel's time goes, on the card.

    python -m gqx_torch.scripts.encode_probe [--reps 20]

Builds ``gqx_torch/csrc/hsq_encode.cu`` with nvcc as it is and in three
variants made by replacing text of the source, and times each by device
time (torch.profiler) at P1's shape: 8 users x 1,470,464 rows of 16, K = 256,
uint8 codes, bf16 and float32 input, passes=1:

- ``kernel``: the kernel as it is;
- ``max``: the selection cut to the running maximum of |p| (its first
  3 of 11 instructions per 4 products, plus the maximum itself);
- ``products``: the selection replaced by a sum of the products: the loads,
  the mma and one read of every product;
- ``products, no loads``: the same with the rows made up in registers from
  their addresses instead of loaded.

Only ``kernel`` computes the encode; the variants' outputs are discarded.
Prints the card (nvidia-smi name and power limit) and one line per variant.
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
from gqx_torch.ops.hsq_prep import bf16_exact_codebook

# the selection's update in the tracking pass, and the global load of a row
SELECT = """          float v = fmaxf(fabsf(p[0][2 * h]), fabsf(p[0][2 * h + 1]));
#pragma unroll
          for (int q = 1; q < kGroup; ++q)
            v = fmaxf(v, fmaxf(fabsf(p[q][2 * h]), fabsf(p[q][2 * h + 1])));
          tie |= v == m[r][h];
          if (v > m[r][h]) {
            m[r][h] = v;
            jg[r][h] = j;
#pragma unroll
            for (int i = 0; i < kKept; ++i) kept[r][h][i] = p[i >> 1][2 * h + (i & 1)];
          }"""
MAX_ONLY = SELECT[:SELECT.index("          tie |=")] + "          m[r][h] = fmaxf(m[r][h], v);"
SUM_ONLY = """#pragma unroll
          for (int q = 0; q < kGroup; ++q) m[r][h] += p[q][2 * h] + p[q][2 * h + 1];"""
LOAD = "    c.v = src[i];"
NO_LOAD = """#pragma unroll
    for (int w = 0; w < kPerPiece; ++w)
      c.w[w] = ((unsigned)(uintptr_t)(src + i) * 2654435761u + 40503u * w) & 0x3F7F3F7Fu;"""

VARIANTS = {
    "kernel": [],
    "max": [(SELECT, MAX_ONLY)],
    "products": [(SELECT, SUM_ONLY)],
    "products, no loads": [(SELECT, SUM_ONLY), (LOAD, NO_LOAD)],
}


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
    """{variant: C entry}, one nvcc per variant, all started together."""
    with open(os.path.join(_build.CSRC_DIR, "hsq_encode.cu")) as f:
        source = f.read()
    jobs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the text to replace is not in hsq_encode.cu once")
            text = text.replace(old, new)
        src, lib = os.path.join(tmp, f"v{i}.cu"), os.path.join(tmp, f"v{i}.so")
        with open(src, "w") as f:
            f.write(text)
        jobs[name] = (lib, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, src],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    entries = {}
    for name, (lib, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out.decode(errors='replace')}")
        fn = ctypes.CDLL(lib).gqx_hsq_encode
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("encode_probe: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {card}", flush=True)
    users, m, dim, k = 8, 1_470_464, 16, 256
    rng = np.random.default_rng(0)
    x32 = torch.from_numpy(rng.standard_normal((users, m * dim), dtype=np.float32)).cuda()
    cb = torch.from_numpy(bf16_exact_codebook(get_codebook(dim, k))).cuda()
    u = torch.empty(users, m, device="cuda")
    codes = torch.empty(users, m, dtype=torch.uint8, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        entries = build(tmp)
        for name, fn in entries.items():
            for x in (x32.bfloat16(), x32):
                def call():
                    err = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), cb.data_ptr(), k, dim,
                             users, m, 1, u.data_ptr(), codes.data_ptr(), 1,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")
                print(f"[encode_probe] {name:<20s} {str(x.dtype)[6:]:>8s}: "
                      f"{device_ms(call, args.reps):.4f} ms", flush=True)


if __name__ == "__main__":
    main()
