"""Where the narrow per-user conv weight-gradient kernel's time goes, on the card.

    python -m gqx_torch.scripts.narrow_probe [--reps 50]

Builds ``gqx_torch/csrc/per_user_dw_narrow.cu`` with nvcc as it is and in
variants made by replacing text of the source, and times each by device
time (torch.profiler) at the ResNet-50 stem's shape: 8 users x 32 images,
3 -> 64 channels at 32 x 32, bf16, 3 x 3 with pads (1, 1):

- ``kernel``: the kernel as it is (2 chunks a warp in flight, 2 blocks per
  multiprocessor);
- ``1 chunk``: one chunk of 32 pixels a warp at a time;
- ``3 blocks/SM``: the launch bounds of 3 blocks per multiprocessor (170
  registers a thread: it spills);
- ``no B loads``: the B fragments made up from their shared-memory offsets
  instead of loaded (what the 16-bit shared loads of shifted x cost);
- ``no mma``: the products replaced by one add per fragment (what the
  tensor cores cost).

Each variant runs with the band rows and ranges of ``ops/dw.py``'s
``narrow_splits``; its time is split into the kernel and the ordered sum of
the ranges.  Only ``kernel``, ``1 chunk`` and ``3 blocks/SM`` compute the
gradient (the first two adding in another order); each output's largest
difference from ``kernel``'s is printed.  Prints the card
(nvidia-smi name and power limit) and one line per variant.
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

LOADS = "          for (int e = 0; e < 8; ++e) v[e] = xs[cbase[nt] + off[e]];"
MMA = """              mma_bf16(acc[m][nt], word(a[k][m][0], 2 * s), word(a[k][m][1], 2 * s),
                       word(a[k][m][0], 2 * s + 1), word(a[k][m][1], 2 * s + 1),
                       pack(v[4 * s], v[4 * s + 1]), pack(v[4 * s + 2], v[4 * s + 3]));"""
VARIANTS = {
    "kernel": [],
    "1 chunk": [("constexpr int kUnroll = 2;", "constexpr int kUnroll = 1;")],
    "3 blocks/SM": [("constexpr int kBlocksPerSM = 2;", "constexpr int kBlocksPerSM = 3;")],
    "no B loads": [(LOADS, "          for (int e = 0; e < 8; ++e) "
                           "v[e] = (unsigned short)(cbase[nt] + off[e]);")],
    "no mma": [(MMA, "              acc[m][nt][s] += __uint_as_float(word(a[k][m][0], 2 * s) ^ "
                     "word(a[k][m][1], 2 * s + 1) ^ pack(v[4 * s], v[4 * s + 3]));")],
}


def kernel_ms(fn, n: int):
    """(device ms of one call, of which the ordered sum of the ranges)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, getattr(e, "self_device_time_total", 0.0)) for e in prof.key_averages()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    total = sum(t for _, t in rows)
    if total == 0.0:
        raise RuntimeError("the profiler saw no device time")
    split_sum = sum(t for key, t in rows if "sum_splits" in key)
    return total / 1e3 / n, split_sum / 1e3 / n


def build(tmp: str):
    """{variant: C entry}, one nvcc per variant, all started together."""
    with open(os.path.join(_build.CSRC_DIR, "per_user_dw_narrow.cu")) as f:
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
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    entries = {}
    for name, (lib, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out.decode(errors='replace')}")
        spills = [ln.strip() for ln in out.decode(errors="replace").splitlines() if "spill" in ln]
        fn = ctypes.CDLL(lib).gqx_per_user_dw_narrow
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 12 + \
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        entries[name] = (fn, spills)
    return entries


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("narrow_probe: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {card}", flush=True)
    users, batch, ci, co, h, w, kh, kw, ph, pw = 8, 32, 3, 64, 32, 32, 3, 3, 1, 1
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(users * batch, ci, h, w, device=dev, generator=gen).to(torch.bfloat16)
    dy = torch.randn(users * batch, co, h, w, device=dev, generator=gen).to(torch.bfloat16)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows, splits = dw_ops.narrow_splits(users, batch, ci, co, h, w, kh, kw, sms)
    out = torch.empty((users, co, ci, kh, kw), dtype=torch.float32, device=dev)
    scratch = torch.empty((splits,) + tuple(out.shape), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    print(f"[shape] {users} users x {batch} images, {ci} -> {co} @{h}x{w}, {kh}x{kw}: "
          f"{rows} rows a piece, {splits} ranges", flush=True)
    want = None
    with tempfile.TemporaryDirectory() as tmp:
        for name, (fn, spills) in build(tmp).items():
            def call():
                err = fn(x.data_ptr(), dy.data_ptr(), users, batch, ci, co, h, w, kh, kw, ph, pw,
                         rows, splits, scratch.data_ptr(), out.data_ptr(), stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            ms, sum_ms = kernel_ms(call, args.reps)
            call()
            torch.cuda.synchronize()
            if want is None:
                want = out.clone()
            diff = float((out - want).abs().max() / want.abs().max())
            print(f"[{name}] {ms:.4f} ms device time, of which the sum of the ranges "
                  f"{sum_ms:.4f} ms; max |out - kernel's| {diff:.2e} of its largest; "
                  f"ptxas: {'; '.join(spills)}", flush=True)


if __name__ == "__main__":
    main()
