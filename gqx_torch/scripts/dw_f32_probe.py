"""Where the float32 tensor-core per-user conv weight-gradient kernel's time
goes, on the card.

    python -m gqx_torch.scripts.dw_f32_probe [--reps 20]

Builds ``gqx_torch/csrc/per_user_dw_tc_f32.cu`` with nvcc as it is and in
variants made by replacing text of the source, and times each by device
time (torch.profiler) at the four float32 geometries of a ResNet's 3x3
convs past the stem (8 users x 32 images, 64 -> 64 @32x32, 128 -> 128
@16x16, 256 -> 256 @8x8, 512 -> 512 @4x4, 3 x 3 with pads (1, 1)), then
per step of ResNet-18 and of ResNet-50 (their counts of each geometry):

- ``kernel``: the kernel as it is (two sets of accumulators, 2 blocks per
  multiprocessor, each chunk copied by cp.async, split and stored between
  two barriers);
- ``overlap``: the next chunk's copies issued before this chunk's mma
  loop and waited for after it;
- ``one set``: all six passes into one set of accumulators (six
  tensor-core roundings a step at the scale of the whole sum);
- ``step sums``: one set, each step's six passes summed from zero and
  added with a float32 add rounded to nearest;
- ``1 pass``: the hh pass alone, one mma per fragment pair instead of six:
  what the other five cost;
- ``no loads``: the chunk's values neither copied nor split (the mma run on
  the zeroed planes): what staging costs;
- ``no global loads``: the raw buffer split and stored as it is, never
  copied: what the copies cost beyond the overlap;
- ``no split``: the values copied and stored as one bf16 piece three
  times: what the split costs.

Each variant runs with the ranges ``ops/dw.py``'s ``batch_splits`` gives
the route; its time includes the ordered sum of the ranges.  For the
first four, which compute the gradient, the largest difference from the
plain version is printed as a share of the summed magnitudes |x| |dy|,
beside what the card tests allow (sqrt(n) * 2^-23, n = B*H*W).
``per_user_dw.cu``, the CUDA-core kernel the route replaced, is timed
beside them.  Prints the card (nvidia-smi name and power limit) and one
line per variant and geometry.
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

# (Ci, Co, H = W, convs of ResNet-18, convs of ResNet-50)
GEOMETRIES = ((64, 64, 32, 4, 3), (128, 128, 16, 3, 3), (256, 256, 8, 3, 5), (512, 512, 4, 3, 2))
PASSES = """                  if (pass < 5) mma_bf16(lo[j][m][2 * h + n], aa, b0, b1);
                  else mma_bf16(acc[j][m][2 * h + n], aa, b0, b1);
                }"""
# all six into one set of accumulators
ONE_SET = """                  mma_bf16(acc[j][m][2 * h + n], aa, b0, b1);
                }"""
# each step's six from zero, then one float32 add into one set
STEP_SUMS = """                  mma_bf16(t[m][n], aa, b0, b1);
                }
#pragma unroll
            for (int m = 0; m < 2; ++m)
#pragma unroll
              for (int n = 0; n < 2; ++n)
#pragma unroll
                for (int q = 0; q < 4; ++q) acc[j][m][2 * h + n][q] += t[m][n][q];"""
PASS_LOOP = """#pragma unroll
            for (int pass = 0; pass < 6; ++pass)"""
COPY_K = """    copy_operand<VEC>(dyo, 0, raw_addr, g, k, by_h);
    copy_operand<VEC>(xo, 1, raw_addr, g, k, by_h);
"""
COPY_NEXT = COPY_K.replace(", k, by_h", ", next, by_h").replace("    ", "      ")
NEXT = "    const Chunk next = more ? make_chunk(g, img0, n_rows, q0, w0) : k;\n"
LOOP = "  while (n_rows > 0) {\n"
OVERLAP = [(COPY_K, ""), (LOOP, "  if (n_rows > 0) {\n" + COPY_K.replace("    ", "  ", 2) + "  }\n" + LOOP),
           (NEXT, NEXT + "    if (more) {\n" + COPY_NEXT + "    }\n")]
COPIES = [(COPY_K, "")]
CONVERT = ("""    convert_operand<VEC>(dyo, 0, raw, smem, plane, k);
    convert_operand<VEC>(xo, 1, raw, smem, plane, k);\n""", "")
SPLIT = """  for (int c = 0; c < 4; ++c) split3(v[2 * c], v[2 * c + 1], w[c]);"""
NO_SPLIT = """  for (int c = 0; c < 4; ++c) w[c][0] = w[c][1] = w[c][2] = pack_bf16(v[2 * c], v[2 * c + 1]);"""
VARIANTS = {
    "kernel": [],
    "overlap": OVERLAP,
    "one set": [(PASSES, ONE_SET)],
    "step sums": [(PASSES, STEP_SUMS),
                  (PASS_LOOP, "            float t[2][2][4] = {};\n" + PASS_LOOP)],
    "1 pass": [("for (int pass = 0; pass < 6; ++pass)", "for (int pass = 5; pass < 6; ++pass)")],
    "no loads": COPIES + [CONVERT],
    "no global loads": COPIES,
    "no split": [(SPLIT, NO_SPLIT)],
}
# the ranges: as batch_splits gives them to the route
PER_SM = dw_ops._ROUTES[dw_ops.TENSOR_CORE_F32][2]


def kernel_ms(fn, n: int) -> float:
    """Device ms of one call (torch.profiler, every kernel it launches)."""
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


def cuda_core_dw(x, dy, users, kh, kw, ph, pw):
    """``per_user_dw.cu``, the CUDA-core kernel that the float32 routes
    replaced (the tensor-core route at 16 input channels or more, the narrow
    route below), through its C entry at any float32 width, with the ranges
    ``batch_splits`` gives it: for timing and checking it beside them.
    Counts no launch (no training path calls it)."""
    n, ci, h, w = x.shape
    co, batch = dy.shape[1], n // users
    out = torch.empty((users, co, ci, kh, kw), dtype=torch.float32, device=x.device)
    splits = dw_ops.batch_splits(users, batch, ci, co, kh, dw_ops._sm_count(x.device),
                                 dw_ops.CUDA_CORE, kw)
    scratch = (torch.empty((splits,) + tuple(out.shape), dtype=torch.float32, device=x.device)
               if splits > 1 else None)
    lib, fn = dw_ops._entry(dw_ops.CUDA_CORE)
    err = fn(x.data_ptr(), dy.data_ptr(), users, batch, ci, co, h, w, kh, kw, ph, pw, splits,
             scratch.data_ptr() if scratch is not None else None, out.data_ptr(),
             _build.stream_ptr(x.device))
    _build.check(lib, err, "per_user_dw (per_user_dw.cu)")
    return out


def build(tmp: str):
    """{variant: (C entry, ptxas lines)}, one nvcc per
    variant, all started together."""
    with open(os.path.join(_build.CSRC_DIR, "per_user_dw_tc_f32.cu")) as f:
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
        fn = ctypes.CDLL(lib).gqx_per_user_dw_tc_f32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 11 + \
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        entries[name] = (fn, regs)
    return entries


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("dw_f32_probe: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {card}", flush=True)
    users, batch = 8, 32
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device=dev).manual_seed(0)
    data = [(torch.randn(users * batch, ci, hw, hw, device=dev, generator=gen),
             torch.randn(users * batch, co, hw, hw, device=dev, generator=gen) * 1e-3)
            for ci, co, hw, _, _ in GEOMETRIES]
    times = {}
    with tempfile.TemporaryDirectory() as tmp:
        variants = build(tmp)
        for name, (fn, regs) in variants.items():
            print(f"[{name}] ptxas: {'; '.join(regs)}", flush=True)
            times[name] = []
            for (ci, co, hw, _, _), (x, dy) in zip(GEOMETRIES, data):
                blocks = users * 3 * -(-ci // 64) * -(-co // 64)
                splits = dw_ops._fewest_ranges(blocks, batch, PER_SM * sms, min(batch, 16))
                out = torch.empty((users, co, ci, 3, 3), dtype=torch.float32, device=dev)
                scratch = torch.empty((splits,) + tuple(out.shape), dtype=torch.float32,
                                      device=dev)

                def call():
                    err = fn(x.data_ptr(), dy.data_ptr(), users, batch, ci, co, hw, hw, 3, 3,
                             1, 1, splits, scratch.data_ptr(), out.data_ptr(), stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")
                ms = kernel_ms(call, args.reps)
                times[name].append(ms)
                err = ""
                if name in ("kernel", "overlap", "one set", "step sums"):
                    call()
                    want = dw_ops.per_user_dw_plain(x, dy, users, 3, 3, 1, 1)
                    mag = dw_ops.per_user_dw_plain(x.abs(), dy.abs(), users, 3, 3, 1, 1)
                    rel = float(((out - want).abs() / mag.clamp_min(1e-30)).max())
                    err = (f"; max |out - plain| {rel:.3e} of the summed magnitudes (allowed "
                           f"{(batch * hw * hw) ** 0.5 * 2.0 ** -23:.3e})")
                print(f"[{name}] {ci}->{co} @{hw}x{hw}: {ms:.4f} ms, {splits} ranges{err}",
                      flush=True)
    times["per_user_dw.cu"] = [
        kernel_ms(lambda: cuda_core_dw(x, dy, users, 3, 3, 1, 1), args.reps) for x, dy in data]
    for name, ms in times.items():
        r18 = sum(g[3] * t for g, t in zip(GEOMETRIES, ms))
        r50 = sum(g[4] * t for g, t in zip(GEOMETRIES, ms))
        print(f"[{name}] per step, 13 convs: ResNet-18 {r18:.4f} ms, ResNet-50 {r50:.4f} ms",
              flush=True)


if __name__ == "__main__":
    main()
