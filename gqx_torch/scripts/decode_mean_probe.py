"""Where the fused HSQ decode-mean kernel's time goes, on the card.

    python -m gqx_torch.scripts.decode_mean_probe [--reps 20]

Builds ``gqx_torch/csrc/hsq_decode_mean.cu`` with nvcc as it is and in
variants made by replacing text of the source, and times each by device
time (torch.profiler) at P1's shape: 8 users x 1,470,464 subvectors of 16,
K = 256, uint8 codes drawn uniformly, passes=1:

- ``kernel``: the kernel as it is;
- ``unpadded codebook``: the codebook's rows in shared memory without their
  float4 of padding (the lanes' reads of random codewords then meet in 2 of
  the 8 four-bank groups);
- ``no codebook reads``: every weight multiplies one float4 of the lane's
  own instead of its codeword (the loads, the duplicate test, the
  arithmetic and the stores, without the gather);
- ``no stores``: the outputs staged but not written to device memory;
- ``no codebook reads, no stores``: both of the above;
- ``no prefetch``: a tile's loads issued only when the tile's turn comes;
- ``no duplicate test``: every user's code weighted on its own;
- ``loads only``: the codes and scales loaded and summed, nothing stored;
- ``3 blocks/SM``, ``4 blocks/SM``: launch bounds for 3 or 4 blocks of 8
  warps per multiprocessor (at most 85 or 64 registers a thread);
- ``4 subvectors a lane``: twice the subvectors (and registers) a lane.

The variants whose names do not start with "no" compute the decode-mean;
their outputs are compared with ``kernel``'s.  Prints the card (nvidia-smi name and power limit) and
one line per variant.
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

GATHER = "      const float4 c = cw[t / 4];"
STORE = """        *reinterpret_cast<float4*>(out + base + 4 * e) =
            *reinterpret_cast<const float4*>(stage + r * ROW + 4 * col);"""
MEAN = """        mean_of<DIM, PASSES, NU>(
            mine + s * DIM, NU, [&](int q) { return (int)c[q][s]; },
            [&](int q) { return v[q][s]; }, cb, inv_users);"""
VARIANTS = {
    "kernel": [],
    "unpadded codebook": [("  static constexpr int PITCH = DIM == 4 ? DIM : DIM + 4;",
                           "  static constexpr int PITCH = DIM;")],
    "no codebook reads": [(GATHER, "      const float4 c = make_float4(w, wh, w, wh);")],
    "no stores": [(STORE, "        reinterpret_cast<float4*>(stage)[e] = make_float4(0, 0, 0, 0);")],
    "no codebook reads, no stores": [
        (GATHER, "      const float4 c = make_float4(w, wh, w, wh);"),
        (STORE, "        reinterpret_cast<float4*>(stage)[e] = make_float4(0, 0, 0, 0);")],
    "no prefetch": [("      if (tile + stride < tiles) load(cn, vn, tile + stride);",
                     "      load(c, v, tile);"),
                    ("""          c[i][e] = cn[i][e];
          v[i][e] = vn[i][e];""", "")],
    "no duplicate test": [("    for (int q = 0; q < i; ++q) first = first && code(q) != ci;", ""),
                          ("    for (int q = i + 1; q < n; ++q) w = code(q) == ci ? w + scale(q) : w;",
                           "")],
    "loads only": [(MEAN, "        { float t = 0.0f; for (int q = 0; q < NU; ++q) "
                          "t += v[q][s] + (float)c[q][s]; mine[s * DIM] = t; }"),
                   (STORE, "        reinterpret_cast<float4*>(stage)[e] = make_float4(0, 0, 0, 0);")],
    "3 blocks/SM": [("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 3)")],
    "4 blocks/SM": [("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 4)")],
    "4 subvectors a lane": [("  static constexpr int kRaw = (PASSES == 1 ? 32 : 16) / DIM;",
                             "  static constexpr int kRaw = (PASSES == 1 ? 64 : 32) / DIM;")],
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
    with open(os.path.join(_build.CSRC_DIR, "hsq_decode_mean.cu")) as f:
        source = f.read()
    jobs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the text to replace is not in the source once")
            text = text.replace(old, new)
        src, lib = os.path.join(tmp, f"v{i}.cu"), os.path.join(tmp, f"v{i}.so")
        with open(src, "w") as f:
            f.write(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", lib, src]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    entries = {}
    for name, (lib, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out.decode(errors='replace')}")
        # registers and spills of P1's instantiation (dim 16, passes 1, uint8, 8 users)
        lines = out.decode(errors="replace").splitlines()
        at = [i for i, ln in enumerate(lines) if "kernelILi16ELi1EhLi8E" in ln and "Compiling" in ln]
        ptxas = " ".join(ln.split(":", 1)[-1].strip() for ln in lines[at[0] + 1:at[0] + 4]
                         if "spill" in ln or "Used" in ln) if at else ""
        fn = ctypes.CDLL(lib).gqx_hsq_decode_mean
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        entries[name] = (fn, ptxas)
    return entries


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("decode_mean_probe: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {card}", flush=True)
    users, m, dim, k = 8, 1_470_464, 16, 256
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    cb = torch.from_numpy(bf16_exact_codebook(get_codebook(dim, k))).to(dev)
    codes = torch.from_numpy(rng.integers(0, k, (users, m)).astype(np.uint8)).to(dev)
    u = torch.from_numpy((rng.standard_normal((users, m)) * 1e-3).astype(np.float32)).to(dev)
    out = torch.empty(m * dim, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    want = None
    with tempfile.TemporaryDirectory() as tmp:
        for name, (fn, ptxas) in build(tmp).items():
            def call():
                err = fn(codes.data_ptr(), 1, u.data_ptr(), cb.data_ptr(), k, dim, users, m, 1,
                         out.data_ptr(), stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            ms = device_ms(call, args.reps)
            same = ""
            if not name.startswith(("no ", "loads")) or name == "no prefetch":
                out.zero_()
                call()
                torch.cuda.synchronize()
                if want is None:
                    want = out.clone()
                same = "; bit-equal to kernel" if torch.equal(out, want) else "; DIFFERS"
            print(f"[{name}] {ms:.4f} ms device time{same}; ptxas: {ptxas}", flush=True)


if __name__ == "__main__":
    main()
