"""Does torch.profiler see every device event of a short window, on the card?

    python -m gqx_torch.scripts.profiler_probe [--reps 3]

Profiles windows of 2, 5 and 20 calls of five functions, each window
``--reps`` times, with CUDA activity alone and with CPU and CUDA activity,
and each window bare or opened by 64 launches of ATen's spin kernel of
10,000 clock cycles (synchronised, then left out of the counts), as
``chip_smoke.py``'s ``device_ms`` opens its windows with longer spins.
The functions: K1 (``hsq_encode_flat``, one kernel a call) at 8 users x
125,000 rows of 16, K = 256, and its plain version (hundreds of kernels a
call); K7 on the float32 tensor-core route (two kernels a call) at 128 ->
128 @16x16, 8 users x 32, and its plain version; an elementwise add and
sum of 2^20 floats.

Prints the card (nvidia-smi name and power limit), then one line per
function, mode and window length: for each window the device ms per call,
the device events of the function seen, how many fewer than the most any
window of that length showed, and the spin kernels seen.
"""

from __future__ import annotations

import argparse
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

from gqx_torch.codebooks import get_codebook
from gqx_torch.ops import dw as dw_ops
from gqx_torch.ops import hsq as hsq_ops

PAD_CALLS = 64
PAD_CYCLES = 10_000
PAD_KEY = "spin_kernel"


def window(fn, calls: int, activities, pad: bool):
    """(device ms per call, the function's device events, spin kernels seen)."""
    with profile(activities=activities) as prof:
        if pad:
            for _ in range(PAD_CALLS):
                torch.cuda._sleep(PAD_CYCLES)
            torch.cuda.synchronize()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    own = [e for e in rows if PAD_KEY not in e.key]
    pads = sum(e.count for e in rows if PAD_KEY in e.key)
    return (sum(e.self_device_time_total for e in own) / 1e3 / calls,
            sum(e.count for e in own), pads)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    torch.manual_seed(0)
    dev = torch.device("cuda")
    flat = torch.randn(8, 2_000_000, device=dev)
    cb = torch.from_numpy(get_codebook(16, 256, device="cpu")).to(dev)
    x = torch.randn(256, 128, 16, 16, device=dev)
    dy = torch.randn(256, 128, 16, 16, device=dev)
    a = torch.randn(1 << 20, device=dev)
    fns = {
        "K1": lambda: hsq_ops.hsq_encode_flat(flat, cb, 16, 2, torch.uint8),
        "K1 plain": lambda: hsq_ops.hsq_encode_flat_plain(flat, cb, 16, 2, torch.uint8),
        "K7 tc f32": lambda: dw_ops.per_user_dw(x, dy, 8, 3, 3, 1, 1),
        "K7 plain": lambda: dw_ops.per_user_dw_plain(x, dy, 8, 3, 3, 1, 1),
        "add, sum": lambda: (a + 1.0).sum(),
    }
    modes = {"cuda": [ProfilerActivity.CUDA],
             "cpu+cuda": [ProfilerActivity.CPU, ProfilerActivity.CUDA]}
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        for mode, activities in modes.items():
            for pad in (False, True):
                for calls in (2, 5, 20):
                    res = [window(fn, calls, activities, pad) for _ in range(args.reps)]
                    most = max(r[1] for r in res)
                    cells = ", ".join(f"{ms:.4f} ms {seen} ev -{most - seen} pad {pads}"
                                      for ms, seen, pads in res)
                    print(f"{name:9s} {mode:8s} {'padded' if pad else 'bare':6s} "
                          f"{calls:2d} calls: {cells}", flush=True)


if __name__ == "__main__":
    main()
