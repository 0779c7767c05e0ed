"""Where the narrow float32 per-user conv weight-gradient kernel's time goes,
on the card.

    python -m gqx_torch.scripts.narrow_f32_probe [--reps 50]

Builds ``gqx_torch/csrc/per_user_dw_narrow_f32.cu`` with nvcc as it is and
in variants made by replacing text of the source, and times each by device
time (torch.profiler) at the ResNet-50 stem's shape: 8 users x 32 images,
3 -> 64 channels at 32 x 32, float32, 3 x 3 with pads (1, 1):

- ``kernel``: the kernel as it is (two accumulator sets, 2 blocks per
  multiprocessor, k-steps of 16 consecutive pixels, the two k-steps of a
  chunk rolled);
- ``one set``: all six passes into one set of accumulators;
- ``1 block/SM``: the launch bounds of 1 block per multiprocessor;
- ``half sectors``: a lane's 8 pixels of a chunk contiguous (k-step s of
  the chunk at 8t + 4s), so that each copy instruction moves 16 of every
  32 bytes it touches;
- ``k-steps unrolled``: the two k-steps of a chunk unrolled;
- ``no B loads``: the B fragments made up from their shared-memory offsets
  instead of loaded (what the 64-bit shared loads of shifted x cost);
- ``no mma``: each product replaced by one three-way XOR into an
  accumulator (what the tensor cores cost);
- ``no split``: dy's values rounded to bf16 h alone, each fragment's three
  pieces the same word (what splitting dy in registers costs).

Each variant runs with the band rows and ranges of ``ops/dw.py``'s
``narrow_splits``; its time is split into the kernel and the ordered sum of
the ranges.  ``per_user_dw.cu``, the CUDA-core kernel the route replaced,
is timed beside them through its C entry.  For the variants that compute
the gradient (all but the last three), the largest and the mean difference
from the plain version are printed as a share of the summed magnitudes
|x| |dy|, beside what the card tests allow (sqrt(n) * 2^-23, n = B*H*W).
Prints the card (nvidia-smi name and power limit), each variant's
registers and spills (ptxas), and one line per variant.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import tempfile

import torch

from gqx_torch.ops import _build
from gqx_torch.ops import dw as dw_ops
from gqx_torch.scripts.dw_f32_probe import cuda_core_dw
from gqx_torch.scripts.narrow_probe import kernel_ms

PASSES = """              if (pass < 5)
                mma_bf16(lo[m][nt], a0[pa], a1[pa], a2[pa], a3[pa], b[nt][pb][0], b[nt][pb][1]);
              else
                mma_bf16(acc[m][nt], a0[pa], a1[pa], a2[pa], a3[pa], b[nt][pb][0], b[nt][pb][1]);"""
ONE_SET = """              mma_bf16(acc[m][nt], a0[pa], a1[pa], a2[pa], a3[pa], b[nt][pb][0], b[nt][pb][1]);"""
NO_MMA = ("              lo[m][nt][pass & 3] = __uint_as_float(__float_as_uint(lo[m][nt][pass & 3]) "
          "^ a0[pa] ^ b[nt][pb][1]);")
LOADS = "          for (int e = 0; e < 4; ++e) v[e] = xs[cbase[nt] + off[e]];"
NO_LOADS = ("          for (int e = 0; e < 4; ++e) "
            "v[e] = make_uint2(cbase[nt] + off[e], (unsigned)off[e]);")
SPLIT = """          split3(r0.x, r0.y, a0);
          split3(r1.x, r1.y, a1);
          split3(r0.z, r0.w, a2);
          split3(r1.z, r1.w, a3);"""
NO_SPLIT = """          a0[0] = a0[1] = a0[2] = pack_bf16(r0.x, r0.y);
          a1[0] = a1[1] = a1[2] = pack_bf16(r1.x, r1.y);
          a2[0] = a2[1] = a2[2] = pack_bf16(r0.z, r0.w);
          a3[0] = a3[1] = a3[2] = pack_bf16(r1.z, r1.w);"""
HALF_SECTORS = [("        const int p = c0 + 4 * tq;\n", "        const int p = c0 + 8 * tq;\n"),
                ("                         p + 16 * s, npx, dy);", "                         p + 4 * s, npx, dy);"),
                ("      const int p = c0 + 4 * tq;   //", "      const int p = c0 + 8 * tq;   //"),
                ("          const int pe = p + 16 * s + e;", "          const int pe = p + 4 * s + e;")]
VARIANTS = {
    "kernel": [],
    "one set": [(PASSES, ONE_SET)],
    "1 block/SM": [("constexpr int kBlocksPerSM = 2;", "constexpr int kBlocksPerSM = 1;")],
    "half sectors": HALF_SECTORS,
    "k-steps unrolled": [("#pragma unroll 1\n      for (int s = 0;", "#pragma unroll\n      for (int s = 0;")],
    "no B loads": [(LOADS, NO_LOADS)],
    "no mma": [(PASSES, NO_MMA)],
    "no split": [(SPLIT, NO_SPLIT)],
}
CHECKED = ("kernel", "one set", "1 block/SM", "half sectors", "k-steps unrolled")


def build(tmp: str):
    """{variant: (C entry, ptxas lines)}, one nvcc per variant, all started
    together."""
    with open(os.path.join(_build.CSRC_DIR, "per_user_dw_narrow_f32.cu")) as f:
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
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR, "-Xptxas", "-v",
               "-o", lib, src]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT))
    entries = {}
    for name, (lib, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out.decode(errors='replace')}")
        regs = [ln.split(":", 1)[-1].strip() for ln in out.decode(errors="replace").splitlines()
                if "registers" in ln or "spill" in ln]
        fn = ctypes.CDLL(lib).gqx_per_user_dw_narrow_f32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 12 + \
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        entries[name] = (fn, regs)
    return entries


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("narrow_f32_probe: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {card}", flush=True)
    users, batch, ci, co, h, w, kh, kw, ph, pw = 8, 32, 3, 64, 32, 32, 3, 3, 1, 1
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(users * batch, ci, h, w, device=dev, generator=gen)
    dy = torch.randn(users * batch, co, h, w, device=dev, generator=gen) * 1e-3
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows, splits = dw_ops.narrow_splits(users, batch, ci, co, h, w, kh, kw, sms,
                                        dw_ops.NARROW_F32)
    out = torch.empty((users, co, ci, kh, kw), dtype=torch.float32, device=dev)
    scratch = torch.empty((splits,) + tuple(out.shape), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    print(f"[shape] {users} users x {batch} images, {ci} -> {co} @{h}x{w}, {kh}x{kw}, float32: "
          f"{rows} rows a piece, {splits} ranges", flush=True)
    want = dw_ops.per_user_dw_plain(x, dy, users, kh, kw, ph, pw)
    mag = dw_ops.per_user_dw_plain(x.abs(), dy.abs(), users, kh, kw, ph, pw)
    allowed = (batch * h * w) ** 0.5 * 2.0 ** -23
    with tempfile.TemporaryDirectory() as tmp:
        for name, (fn, regs) in build(tmp).items():
            def call():
                err = fn(x.data_ptr(), dy.data_ptr(), users, batch, ci, co, h, w, kh, kw, ph, pw,
                         rows, splits, scratch.data_ptr(), out.data_ptr(), stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            ms, sum_ms = kernel_ms(call, args.reps)
            err = ""
            if name in CHECKED:
                call()
                torch.cuda.synchronize()
                rel = (out - want).abs() / mag.clamp_min(1e-30)
                err = (f"; |out - plain| of the summed magnitudes: max {float(rel.max()):.3e}, "
                       f"mean {float(rel.mean()):.3e} (allowed {allowed:.3e})")
            print(f"[{name}] {ms:.4f} ms device time, of which the sum of the ranges "
                  f"{sum_ms:.4f} ms{err}; ptxas: {'; '.join(regs)}", flush=True)
    ms, sum_ms = kernel_ms(lambda: cuda_core_dw(x, dy, users, kh, kw, ph, pw), args.reps)
    print(f"[per_user_dw.cu] {ms:.4f} ms device time, of which the sum of the ranges "
          f"{sum_ms:.4f} ms", flush=True)


if __name__ == "__main__":
    main()
