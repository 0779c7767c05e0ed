"""Benchmark of the port (counterpart of the root ``bench.py``): training
steps per second of the canonical comparison on one CUDA device.

    python -m gqx_torch.bench [--quant hsq,sgd,...] [--network resnet50]
        [--dtype bfloat16] [--folded 1] [--warmup 3] [--steps 50] [--out PATH]

For each configuration of ``CANONICAL`` (8 users x 32, synthetic
CIFAR-shaped inputs from ``np.random.default_rng(0)``, lr 0.1, wd 5e-4,
error-feedback scale 1): one first step (which builds and loads the
kernels), ``--warmup`` steps, then a window of ``--steps`` steps timed on
the host clock up to ``torch.cuda.synchronize``.  Then three more steps
under torch.profiler give the device time per step (the kernels' own
time, as ``chip_smoke.py`` measures it), its share of the host time per
step, and its split by family (``classify``): convolutions, GEMMs and
einsums, BN forward, BN backward, casts and copies, the SGD update, each
hand-written kernel by name, the rest, and what no CPU op launched
(unattributed).

Logs a table to stderr.  Prints on stdout a line of details (JSON) and,
last, one line in the shape of the root bench.py's:
    {"metric": ..., "value": steps_per_sec, "unit": "steps/s", "vs_baseline": null}
It writes no file unless ``--out`` names one.  A configuration that fails
raises: there is no fallback to another network, to a kernel-only figure
or to the CPU.  ``--platform cpu`` runs the plain PyTorch path on the CPU
(for tests); its device figures are then not measured (null).
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
import sys
import time
from typing import Dict, Sequence

import numpy as np
import torch

# the five configurations of the canonical comparison (reference
# README.md:3-32; a copy of the root bench.py's CANONICAL)
CANONICAL = {
    "hsq": dict(quantizer="hsq", c_dim=16, k_bit=8, n_bit=6),
    "sgd": dict(quantizer="sgd"),
    "qsgd2bit": dict(quantizer="qsgd", c_dim=128, n_bit=2),
    "terngrad": dict(quantizer="terngrad"),
    "sign": dict(quantizer="sign"),
}
USERS, BATCH, IMAGE = 8, 32, (32, 32, 3)
PROFILED_STEPS = 3

# the hand-written kernels, by the name of their __global__ function
HAND_WRITTEN = {
    "hsq_encode_tc_kernel": "K1 hsq_encode",
    "hsq_decode_mean_kernel": "K2 hsq_decode_mean",
    "philox_uniform_kernel": "K3 philox_uniform",
    "gather_scale_kernel": "K4/K6 decode",
    "hsq_rows_encode_tc_kernel": "K6 rows_encode_tc",
    "hsq_rows_encode_wide_kernel": "K6 rows_encode_wide",
    "split_codebook_kernel": "K6 rows_encode_wide (codebook split)",
    "hsq_rows_encode_kernel": "K6 rows_encode (CUDA cores)",
    "per_user_dw_tc_kernel": "K7 per_user_dw_tc",
    "per_user_dw_narrow_kernel": "K7 per_user_dw_narrow",
    "per_user_dw_tc_f32_kernel": "K7 per_user_dw_tc_f32",
    "per_user_dw_narrow_f32_kernel": "K7 per_user_dw_narrow_f32",
    "per_user_dw_kernel": "K7 per_user_dw (CUDA cores)",
}
BN_FORWARD = "gqx_torch::bn.forward"   # the program's range round each BN forward
CONV_OPS = {"aten::convolution", "aten::_convolution", "aten::convolution_backward",
            "aten::cudnn_convolution", "aten::cudnn_convolution_transpose"}
GEMM_OPS = {"aten::mm", "aten::bmm", "aten::addmm", "aten::matmul", "aten::einsum",
            "aten::linear", "aten::baddbmm"}
COPY_OPS = {"aten::copy_", "aten::_to_copy", "aten::to", "aten::clone", "aten::contiguous",
            "aten::cat", "aten::stack", "aten::constant_pad_nd"}
UNATTRIBUTED = "unattributed (launched outside any CPU op)"
FAMILIES = ("convolutions", "GEMMs/einsums", "BN forward", "BN backward", "casts and copies",
            "SGD update", "the rest")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def classify(kernel: str, ops: Sequence[str]) -> str:
    """The family of a device kernel, from its name and the names of the
    CPU ops it was launched under, innermost first (the profiler's CPU-op
    parents).  A hand-written kernel is its own family; otherwise the BN
    autograd node or forward range, the foreach ops of the SGD update, a
    convolution, a GEMM and a copy are looked for in that order."""
    for token in re.findall(r"[A-Za-z_]\w*", kernel):
        if token in HAND_WRITTEN:
            return HAND_WRITTEN[token]
    if not ops:
        return UNATTRIBUTED
    if any("GroupedBatchNormBackward" in op for op in ops):
        return "BN backward"
    if BN_FORWARD in ops:
        return "BN forward"
    if any(op.startswith("aten::_foreach_") for op in ops):
        return "SGD update"
    for family, names in (("convolutions", CONV_OPS), ("GEMMs/einsums", GEMM_OPS),
                          ("casts and copies", COPY_OPS)):
        if any(op in names for op in ops):
            return family
    return "the rest"


def is_op(name: str) -> bool:
    """Whether a profiler CPU event that holds kernels is an op.  The
    profiler's own events ("Activity Buffer Request", "Command Buffer
    Full") and CUDA runtime calls made outside an op ("cudaLaunchKernel")
    can share an op's correlation id and hold copies of its kernels; op
    names have no spaces and do not start with "cuda"."""
    return " " not in name and not name.startswith("cuda")


def op_chain(event):
    """The names of a profiler CPU event and of its CPU-op parents,
    innermost first."""
    ops = []
    while event is not None:
        ops.append(event.name)
        event = event.cpu_parent
    return ops


def device_split(step, n: int):
    """Run ``step`` ``n`` times under torch.profiler (CPU and CUDA); returns
    (device ms per step, {family: device ms per step}, {(family, innermost
    op): device ms per step}).  Hand-written kernels are counted from the
    device events by name; every other kernel through the CPU op that
    launched it; what no op holds is unattributed (were a kernel held
    twice, it would come out negative).  The window opens with spin
    kernels, left out of every sum (``utils.profiling``), and is profiled
    again with longer spins where none of them shows; it raises after
    three such windows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gqx_torch.utils.profiling import PAD_CYCLES, SPAN_NAMES, is_pad, pad_window

    for cycles in PAD_CYCLES:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            pad_window(cycles)
            for _ in range(n):
                step()
            torch.cuda.synchronize()
        events = prof.events()
        # kernels, copies and sets; not the device-side spans of the
        # program's ranges (user annotations), which overlap kernels
        device = [e for e in events if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False) and e.name not in SPAN_NAMES]
        pads = sum(1 for e in device if is_pad(e.name))
        device = [e for e in device if not is_pad(e.name)]
        total = sum(e.time_range.elapsed_us() for e in device)
        if pads and total > 0:
            break
    else:
        raise RuntimeError(f"the profiler lost the device events of {len(PAD_CYCLES)} "
                           "windows")
    split = collections.Counter()
    by_op = collections.Counter()
    for e in device:
        family = classify(e.name, ())
        if family != UNATTRIBUTED:
            split[family] += e.time_range.elapsed_us()
    for e in events:
        if e.device_type != DeviceType.CPU or not e.kernels or not is_op(e.name):
            continue
        ops = op_chain(e)
        for k in e.kernels:
            if k.name in SPAN_NAMES or is_pad(k.name):
                continue
            family = classify(k.name, ops)
            if family in FAMILIES:
                split[family] += k.duration
                by_op[(family, ops[0])] += k.duration
    split[UNATTRIBUTED] = total - sum(split.values())
    scale = 1e-3 / n
    return (total * scale, {f: v * scale for f, v in split.items()},
            {k: v * scale for k, v in by_op.items()})


def card_line():
    """nvidia-smi's name and power limit of the card, or None without it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0]


def measure(name: str, network: str, dtype: str, folded: bool, device: torch.device,
            warmup: int, steps: int) -> Dict:
    """One configuration of CANONICAL; returns its row of the details."""
    from gqx_torch.config import GQConfig
    from gqx_torch.models import create_model
    from gqx_torch.runner import to_device
    from gqx_torch.train import create_train_state, make_train_step
    from gqx_torch.utils.timing import timeit

    cfg = GQConfig(network=network, dataset="synthetic", num_users=USERS, batch_size=BATCH,
                   seed=1, compute_dtype=dtype, folded_users=folded, **CANONICAL[name])
    model = create_model(network, cfg.num_classes, dtype, torch.Generator().manual_seed(0),
                         image_shape=IMAGE)
    state, plan = create_train_state(cfg, model, device=device)
    train_step = make_train_step(cfg, plan)
    total_params = sum(p.numel() for p in model.parameters())
    wire = plan.wire_bytes()

    rng = np.random.default_rng(0)
    x, y = to_device(rng.standard_normal((USERS, BATCH) + IMAGE).astype(np.float32),
                     rng.integers(0, 10, size=(USERS, BATCH)), device)
    generator = torch.Generator().manual_seed(1)

    def step():
        return train_step(state, x, y, 0.1, 5e-4, generator, 1.0)

    t0 = time.perf_counter()
    float(step())
    first_s = time.perf_counter() - t0
    per_step, out = timeit(step, n=steps, warmup=warmup)
    loss = float(out)
    if not np.isfinite(loss):
        raise RuntimeError(f"{name}: non-finite loss {loss}")
    row = {
        "steps_per_sec": 1.0 / per_step,
        "ms_per_step": 1e3 * per_step,
        "first_step_s": first_s,
        "loss": loss,
        "wire_bytes_per_user_step": wire,
        "compression_ratio_vs_fp32": 4.0 * total_params / max(wire, 1),
        "device_ms_per_step": None,
        "device_share": None,
        "device_split_ms": None,
    }
    if device.type == "cuda":
        dev_ms, split, by_op = device_split(step, PROFILED_STEPS)
        row.update(device_ms_per_step=dev_ms, device_share=dev_ms / row["ms_per_step"],
                   device_split_ms=split,
                   top_ops_ms={f"{f} | {op}": v for (f, op), v in
                               sorted(by_op.items(), key=lambda kv: -kv[1])[:12]})
    log(f"[{name}] {network} {dtype} {'folded' if folded else 'loop'}: "
        f"{row['steps_per_sec']:.3f} steps/s, {row['ms_per_step']:.2f} ms/step over {steps} "
        f"steps (first step {first_s:.1f} s), device "
        + ("not measured" if row["device_ms_per_step"] is None else
           f"{row['device_ms_per_step']:.2f} ms/step ({100 * row['device_share']:.1f}%)")
        + f", wire {wire} B/user/step ({row['compression_ratio_vs_fp32']:.1f}x), loss {loss:.4f}")
    return row


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="gqx_torch benchmark: training steps/s of the "
                                            "canonical comparison")
    p.add_argument("--quant", type=str, default=",".join(CANONICAL),
                   help="comma-separated configurations of CANONICAL")
    p.add_argument("--network", type=str, default="resnet50")
    p.add_argument("--dtype", type=str, default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--folded", type=int, default=1, choices=[0, 1])
    p.add_argument("--platform", type=str, default=None,
                   help="cpu: the plain PyTorch path on the CPU; unset, cuda or gpu: the card")
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--out", type=str, default=None, help="also write the details here (JSON)")
    return p


def main(argv=None) -> Dict:
    args = build_parser().parse_args(argv)
    from gqx_torch import resolve_device
    from gqx_torch.cli import device_from_args

    quants = args.quant.split(",")
    unknown = [q for q in quants if q not in CANONICAL]
    if unknown:
        raise ValueError(f"unknown configurations {unknown}; choose from {list(CANONICAL)}")
    device = resolve_device(device_from_args(args))
    if device.type == "cuda":
        from gqx_torch.ops import _build

        log(f"[build] {len(_build.SOURCES)} sources: {_build.build():.1f} s")
        kind, card = torch.cuda.get_device_name(0), card_line()
    else:
        kind, card = "cpu", None
    log(f"[device] {kind}; card {card}; torch {torch.__version__}")
    configs = {}
    for q in quants:
        configs[q] = measure(q, args.network, args.dtype, bool(args.folded), device,
                             args.warmup, args.steps)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    details = {"network": args.network, "device": kind, "card": card, "users": USERS,
               "batch_per_user": BATCH, "compute_dtype": args.dtype,
               "folded_users": bool(args.folded),
               "window": {"first": 1, "warmup": args.warmup, "steps": args.steps,
                          "profiled": PROFILED_STEPS if device.type == "cuda" else 0},
               "configs": configs}
    _log_table(details)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(details, f, indent=1)
    head = "hsq" if "hsq" in configs else quants[0]
    what = "hsq(d16,K256,n6)" if head == "hsq" else head
    print(json.dumps(details), flush=True)
    print(json.dumps({
        "metric": f"train steps/s, {args.network}/cifar10-shape, {what}, {USERS} users, "
                  f"batch {BATCH}, {args.dtype}, 1 x {kind}",
        "value": configs[head]["steps_per_sec"],
        "unit": "steps/s",
        "vs_baseline": None,
    }), flush=True)
    return details


def _log_table(details) -> None:
    configs = details["configs"]
    for q, r in configs.items():
        dev = r["device_ms_per_step"]
        log(f"  {q:10s} {r['steps_per_sec']:8.3f} steps/s {r['ms_per_step']:9.2f} ms/step  device "
            + ("not measured" if dev is None else f"{dev:8.2f} ms ({100 * r['device_share']:5.1f}%)")
            + f"  wire {r['wire_bytes_per_user_step'] / 1e6:8.3f} MB "
              f"({r['compression_ratio_vs_fp32']:6.1f}x)")
    if "hsq" in configs and "sgd" in configs:
        log(f"  hsq / sgd ms per step: {configs['hsq']['ms_per_step'] / configs['sgd']['ms_per_step']:.3f}")
    for q, r in configs.items():
        split = r["device_split_ms"]
        if split is None:
            continue
        log(f"  [{q}] device ms per step by family (sum {sum(split.values()):.3f} of "
            f"{r['device_ms_per_step']:.3f}):")
        for family, ms in sorted(split.items(), key=lambda kv: -kv[1]):
            log(f"    {ms:9.3f}  {family}")


if __name__ == "__main__":
    main()
