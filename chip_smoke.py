#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gqx_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--steps N]

1. Prints the card (nvidia-smi name and power limit) and the torch/CUDA
   versions.
2. Builds the kernels from gqx_torch/csrc with nvcc (one process per
   source, all at once) and prints the build time.
3. Holds each kernel against its plain PyTorch version at the shapes the
   training paths give it (the ResNet-50 HSQ unit, 8 users): the flat
   encode (on the tensor cores; at P1's, P2's and P3's shapes and at P9's
   unpadded float32 unit at passes=2, timed by device time with CUDA
   events beside it), the fused decode-mean, the uniforms and the per-user
   decode at dim 16 / K 256 (the decode at P9's unit too), the row-major
   encode (both routes, bf16 and float32 rows: dim <= 32 on the tensor
   cores at P4's dim 8 / K 1024; dims above 32 on the wide tensor-core
   route at P6's shape, dim 256 / K 256, with hsq_rows_encode.cu, the
   CUDA-core kernel it replaced, timed beside it) and decode, plus ragged
   dims (up to 576) and codebooks larger than shared memory, on both input
   types; the per-user conv
   weight gradient at every geometry of the stride-1 same-size convs of
   ResNet-50, VGG-16 and DenseNet-BC in bf16 (8 users x 32: the stems on
   the narrow kernel, the others on the tensor-core kernel) and of
   ResNet-18, ResNet-50, VGG-16 and DenseNet-BC in float32 (the stems on
   the narrow float32 kernel, the others on the float32 tensor-core
   kernel, with per_user_dw.cu, the CUDA-core kernel both replaced,
   checked and timed beside each), each weighted by its count in a step of
   each network, and at odd ones on all four
   routes; and times kernel, plain version and, where one
   exists, the PyTorch call computing the same function (for the conv
   weight gradient, one grouped call for all users, with the per-user
   calls beside it).
   [kmeans] Trains the (576, 256) codebook that P12's stem needs (no file
   holds it) at gqx's defaults (1M samples, 20 iterations, seed 808) on
   the card through ``get_codebook`` into an empty temporary cache, and
   prints its wall ms; holds the card's Lloyd iterations against the
   CPU's on the same 65,536 x 576 samples and initial rows, each of 5
   iterations from the CPU's centroids (assignments may differ only on
   near-ties, centroids by what a moved row moves); trains (16, 256) on
   the card and scores it against the shipped file, which gqx's k-means
   wrote (the mean best cosine over 200,000 fresh unit samples within
   0.5%).
4. Runs eleven training paths (CIFAR ResNet-50 but for P10 and P11, 8 users
   x 32, bf16 compute but for P7, hsq_passes=1, random weights and data
   from --seed), each for
   one warm-up step and --steps steps with the launch counters set to 0
   just before and read just after:
     P1  HSQ c_dim 16 / k_bit 8 / n_bit 6, parameter server, folded users
         (canonical);
     P2  P1 with error feedback and the two-phase downlink;
     P3  P1 as a chain ring;
     P4  HSQ c_dim 8 / k_bit 10 (the row-major kernels, the encode on the
         tensor cores);
     P5  P1 with folded_users=False (the per-user loop), one step;
     P7  P1 with float32 compute, gqx's default (float32 units; the conv
         weight gradient on the float32 routes);
     P8  P1 with HSQ c_dim 256 / k_bit 8 and passthrough_threshold 2048
         (one row-major unit of 91,904 rows of 256, K 256: the wide route;
         the stem passed through uncompressed);
     P9  Residual c_dim 16 / k_bit 8 / n_bit 6: HSQ at passes=2 on an
         unpadded float32 unit (the flat encode, the uniforms, the per-user
         decode), then PVQ on the residual (its samples' uniforms, the
         row-major decode);
     P10 P1 on VGG-16 (max pooling, conv biases);
     P11 P1 on DenseNet-BC (``dense``: the channel concatenation), both
         with their device time split by family as gqx_torch.bench splits
         it;
     P12 P1 with HSQ c_dim 256 / k_bit 8 at the default passthrough
         threshold: the grouped unit of 91,904 rows of 256 and the stem's
         unit of 3 rows of 576 a user (the codebook [kmeans] trained), both
         on the wide route, whose encode and decode are also held to their
         plain versions and timed at the stem's 24 rows;
   and P6, HSQ c_dim 256 / k_bit 8 on the gradient unit of P1's plan through
   the compressor's entry points (compress_batch, decode_mean; the encode
   on the wide route), its launches counted the same way.
   The counters must equal what the code implies (the per-user conv weight
   gradient per folded step by route, from the network's convs and the
   compute dtype: ResNet-50 13 tensor-core and 1 narrow launches in bf16,
   13 float32 tensor-core and 1 narrow float32 in float32; VGG-16 12 + 1,
   DenseNet-BC 58 + 1; the row-major encode by route).  The aggregate of
   one more step of each of P1-P4 and P7-P11 (and P2's new
   error-feedback state) is recomputed on the CPU through the plain
   versions from the same gradients, state and seed, and compared; so is
   P6's decode-mean.  Where a unit samples codes (PVQ, Maurey), every
   sample that lands in another slot than on the CPU must lie at a CDF
   boundary.
   [mesh] Then the distributed backend (gqx_torch.parallel.collectives)
   as one NCCL rank in process (a world of one: NCCL takes one rank a
   card): PS logical, PS packed, PS packed with EF and two-phase, the
   chain ring and the segmented ring at P1's width, 1 + --steps steps each
   beside the sim step of the same configuration from the same state,
   batch and seed (cuDNN deterministic for the phase).  All but the
   segmented ring must end bit-equal to the sim step (parameters, BN
   statistics, momentum, EF); the segmented ring's aggregate of one more
   step is held to its CPU plain run (gloo, W = 1) with the near-tie rule.
   Launches are counted as the paths' are; ms/step against the sim's,
   device ms, and for the packed runs pack, all_gather and unpack ms per
   user and step and the gathered bytes, which must be P1's wire_bytes.
5. Compares folded and looped per-user gradients from the same weights and
   batch on the card: ResNet-18 float32, ResNet-50, VGG-16 and DenseNet-BC
   bf16, with the conv weight gradient's launches of each folded run
   counted (the float32 run: 13 float32 tensor-core and 1 narrow float32
   launches).
6. Steps the four other configurations of the canonical comparison (sgd,
   qsgd2bit, terngrad, sign) and the other three compressors (topk, maurey,
   pvq), folded, their launches counted as the paths' are; the qsgd, sign,
   topk (exactly), maurey and pvq aggregates are recomputed on the CPU like
   the others.  Takes one eval step.
7. [cli] Drives ``gqx_torch.cli.main`` in process with gqx's canonical
   HSQ command line (ResNet-50, 8 users x 32, synthetic data, gqx's default
   float32 compute): one epoch of 16 steps, then two epochs with --resume
   on the same logdir, which must continue to step 32; the counters, set
   to 0 before each run and read after, must show 13 float32 tensor-core
   and 1 narrow float32 conv weight gradient launches and one of the
   encode, the uniforms and the decode-mean a step; scalars.csv must hold
   gqx's tags at gqx's global steps, all finite.  Then VGG-16 in float32
   for one epoch (K7 12 float32 tensor-core and 1 narrow float32 launches a
   step), the LeNet CNN for 8 steps on MNIST-format files made from the
   seed (no K7), and the verify skill's FCN drive, which must end at >= 99%
   test accuracy; each with one encode, uniforms and decode-mean a step.
   [cli mesh] Then the canonical command line with --backend mesh --wire
   packed, one NCCL process over a TCP rendezvous on localhost: 16 steps,
   [cli]'s launches a step.
   [cli c256] Then ResNet-50 at c_dim 256 / k_bit 8 and the default
   threshold, float32, one epoch, with an empty codebook cache: the run
   trains the stem's codebook on the card, and launches 2 wide encodes, 2
   uniform draws and 2 row decodes a step.
8. [bench] Runs ``gqx_torch.bench`` for hsq and sgd (bf16, 1 + 1 + 5
   steps), then for hsq in float32: the families of each device-time
   split must sum to its device total within 1%.  The float32 hsq ms per
   step is printed beside the runner's of step 7 (the gap is the data
   pipeline's cost).
9. [wire] Packs one user's signature of one ResNet-50 unit of each of the
   eight compressors (P1's HSQ unit, P9's Residual unit) on the card, for
   each of 8 users: the words must equal the CPU's pack of the same
   signature, the unpack must give it back bit for bit, and the payload's
   bytes must be ``wire_bytes``; times pack and unpack per user and step.
   [native] The port's C++ data library (gqx_torch/csrc/gqx_native.cc):
   the augment of a CIFAR-sized global batch (shape, dtype, range), a
   no-augment dataset and normalize equal to numpy's, the host ms of the
   native and the numpy augment with the OpenMP thread count, pack /
   unpack equal to gqx_torch/ops/pack.py at every width 1-32, and the
   Pipeline's default augment, which must be the native one.
10. Prints the wall time, the ``kernels`` JSON line, the card line and,
   last, the result line {"ok": true, "device": {...}}.

Any failed check raises, so the script exits non-zero and prints no result
line; without a CUDA device it exits at once.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

from gqx_torch.utils.profiling import PAD_CALLS, PAD_CYCLES, is_pad, pad_window

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s, bf16 tensor FLOP/s,
# fp32 (non-tensor) FLOP/s, used as the scalar-pipe rate for integer work
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, n: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


# torch.profiler on the H100 drops the leading device events of a window:
# mostly up to some nine (gqx_torch/scripts/profiler_probe.py: a one-kernel
# function showed 0 of 2, 0 or 5 of 5, 13 of 20 events; a plain version 51
# of 60), now and then a whole window of 69 (run I: three in a row, as the 9
# us pack of run F1).  Each window opens with PAD_CALLS spins
# (gqx_torch/utils/profiling.py), left out of the sums; a window that shows
# none of them may have lost events of its own, and is profiled again with
# spins ten times longer.  The spin kernels seen per window, over the run:
PADS_SEEN = []


def device_rows(prof):
    """(self device us, count, key) of each device kernel, copy or set in a
    profile, the leading spin kernels left out; and how many of those the
    profile shows."""
    import torch

    rows = [(getattr(e, "self_device_time_total", 0.0), e.count, e.key)
            for e in prof.key_averages()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    pads = sum(c for _, c, k in rows if is_pad(k))
    PADS_SEEN.append(pads)
    return [r for r in rows if not is_pad(r[2])], pads


def device_ms(fn, n: int) -> float:
    """Device time of one call of ``fn``: the kernels' time summed by
    torch.profiler over ``n`` calls, over ``n``.  Unlike CUDA events around
    the calls, it does not count the time the card waits for the host.
    Raises where no window shows both device time of ``fn`` and some of
    its leading spin kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for cycles in PAD_CYCLES:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            pad_window(cycles)
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        rows, pads = device_rows(prof)
        total = sum(r[0] for r in rows)
        if pads and total > 0.0:
            return total / 1e3 / n
        log(f"[profile] a window of {n} calls showed {pads} of its {PAD_CALLS} leading spin "
            f"kernels of {cycles} cycles and {total:.1f} us of device time: profiled again")
    raise AssertionError(f"the profiler lost the device events of {len(PAD_CYCLES)} windows "
                         f"of {n} calls")


def bound(bytes_moved: float, ops: float, peak_ops: float):
    t_bytes = bytes_moved / HBM_BPS * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# the training paths: what each adds to the canonical configuration, and the
# launches of each kernel per step and HSQ unit that the code implies (U: once
# per user; every kernel not named: none)
PATHS = {
    "P1": (dict(), dict(hsq_encode=1, philox_uniform=1, hsq_decode_mean=1)),
    "P2": (dict(ef=True, two_phase=True),
           dict(hsq_encode=2, philox_uniform=2, hsq_decode=2)),
    "P3": (dict(mode="ring"), dict(hsq_encode="U", philox_uniform="U", hsq_decode="U")),
    "P4": (dict(c_dim=8, k_bit=10),
           dict(hsq_rows_encode_tc=1, philox_uniform=1, hsq_rows_decode=1)),
    "P5": (dict(folded_users=False), dict(hsq_encode=1, philox_uniform=1, hsq_decode_mean=1)),
    # gqx's default compute dtype: float32 units, the float32 K7 routes
    "P7": (dict(compute_dtype="float32"),
           dict(hsq_encode=1, philox_uniform=1, hsq_decode_mean=1)),
    # the wide row-major route in training with the stem passed through (it
    # still takes its per-user gradient from the narrow K7 kernel, 13 + 1 a
    # step): one HSQ unit of 91,904 rows of 256 (P12 compresses the stem)
    "P8": (dict(c_dim=256, k_bit=8, passthrough_threshold=2048),
           dict(hsq_rows_encode_wide=1, philox_uniform=1, hsq_rows_decode=1)),
    # Residual: one float32 unit of 23,498,432 elements, not padded (only
    # HSQ units are); the HSQ stage at passes=2 (the encode, the uniforms of
    # its norms, the per-user decode of the residual), PVQ on the residual
    # (the uniforms of its samples and of its norms), then the mean of the
    # stages' per-user decodes (the flat decode again, the row-major decode)
    "P9": (dict(quantizer="residual", c_dim=16, k_bit=8, n_bit=6),
           dict(hsq_encode=1, philox_uniform=3, hsq_decode=2, hsq_rows_decode=1)),
    # P1 on the other model families: VGG-16 (max pooling, conv biases; K7 at
    # widening convs and 2x2 planes) and DenseNet-BC (the channel
    # concatenation; K7 at 48 -> 12, 12 of a 64-row channel tile)
    "P10": (dict(network="vgg16"), dict(hsq_encode=1, philox_uniform=1, hsq_decode_mean=1)),
    "P11": (dict(network="dense"), dict(hsq_encode=1, philox_uniform=1, hsq_decode_mean=1)),
    # HSQ c_dim 256 / k_bit 8 at the default passthrough threshold (1000): the
    # grouped unit of 91,904 rows of 256 and, as a unit of its own, the stem's
    # 1,728 weights as 3 rows of 576 per user with the codebook [kmeans]
    # trained; both on the wide route
    "P12": (dict(c_dim=256, k_bit=8),
            dict(hsq_rows_encode_wide=1, philox_uniform=1, hsq_rows_decode=1)),
}
# the paths whose device time is also split by family (gqx_torch.bench)
SPLIT_PATHS = ("P10", "P11")
# P6, the wide row-major encode (dim 256 is outside the flat layout and above
# the tensor-core encode's 32) through the compressor's entry points on the
# gradient unit of P1's plan; launches per call of compress_batch and
# decode_mean
WIDE_ROWS = (dict(c_dim=256, k_bit=8),
             dict(hsq_rows_encode_wide=1, philox_uniform=1, hsq_rows_decode=1))
EF_EPOCH = 1.0   # the error-feedback scale is config.ef_scale(EF_EPOCH)

# the networks whose stride-1 same-size KxK convs (the per_user_dw kernels' in
# the folded step) dw_kernel_phase checks and times, per compute dtype: every
# geometry of each, weighted by its count in a step of each (dw_convs)
DW_NETWORKS = {
    "bfloat16": {"ResNet-50": "resnet50", "VGG-16": "vgg16", "DenseNet-BC": "dense"},
    "float32": {"ResNet-18": "resnet18", "ResNet-50": "resnet50", "VGG-16": "vgg16",
                "DenseNet-BC": "dense"},
}
# the kernel entry of each per_user_dw route
DW_ENTRY = {"tensor_core": "per_user_dw_tc", "narrow": "per_user_dw_narrow",
            "tensor_core_f32": "per_user_dw_tc_f32", "narrow_f32": "per_user_dw_narrow_f32",
            "cuda_core": "per_user_dw"}


@functools.lru_cache(maxsize=None)
def dw_convs(network: str):
    """{(ci, co, h, w, kh, kw): count} of ``network``'s convs whose per-user
    weight gradient the folded step takes from per_user_dw: stride 1, a
    window of more than one tap, and an output of the input's size (the
    condition of ``models.folded.SharedConv``), read off one CPU forward of
    one image at the model's own image shape."""
    import torch

    from gqx_torch.models import create_model
    from gqx_torch.models.common import Conv2d

    model = create_model(network, 10).eval()
    found = collections.Counter()

    def hook(mod, inputs, out):
        x = inputs[0]
        kh, kw = mod.weight.shape[2:]
        if mod.stride == 1 and kh * kw > 1 and out.shape[2:] == x.shape[2:]:
            found[(x.shape[1], out.shape[1], x.shape[2], x.shape[3], kh, kw)] += 1

    handles = [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, Conv2d)]
    h, w, c = model.image_shape
    with torch.no_grad():
        model(torch.zeros(1, c, h, w))
    for handle in handles:
        handle.remove()
    return dict(found)


@functools.lru_cache(maxsize=None)
def dw_per_step(network: str, dtype: str):
    """The per_user_dw launches of one folded step of ``network`` in
    ``dtype``, keyed by kernel entry (every entry present, most 0)."""
    import torch

    from gqx_torch.ops import dw as dw_ops

    table = dict.fromkeys(DW_ENTRY.values(), 0)
    for (ci, _, _, _, _, kw), n in dw_convs(network).items():
        table[DW_ENTRY[dw_ops.route(getattr(torch, dtype), ci, kw)]] += n
    return table


# the other configurations of the canonical comparison, then the other
# compressors of gqx's registry, with their launches per unit and step as
# PATHS has them (topk and maurey units are one leaf each)
COMPARISON = {
    "sgd": (dict(quantizer="sgd"), dict()),
    "qsgd2bit": (dict(quantizer="qsgd", c_dim=128, n_bit=2), dict(philox_uniform=1)),
    "terngrad": (dict(quantizer="terngrad"), dict(philox_uniform=1)),
    "sign": (dict(quantizer="sign"), dict()),
    "topk": (dict(quantizer="topk"), dict()),
    "maurey": (dict(quantizer="maurey", c_dim=16, k_bit=8, n_bit=6), dict(philox_uniform=1)),
    "pvq": (dict(quantizer="pvq", c_dim=16, k_bit=8, n_bit=6),
            dict(philox_uniform=2, hsq_rows_decode=1)),
}
# units whose aggregate is compared subvector by subvector
SUBVECTOR_UNITS = ("HSQCompressor", "ProbabilisticVectorCompressor", "ResidualCompressor")


def canonical_config(quantizer: str = "hsq", **extra):
    from gqx_torch.config import GQConfig

    kw = dict(network="resnet50", compute_dtype="bfloat16")
    if quantizer == "hsq":
        kw.update(c_dim=16, k_bit=8, n_bit=6)
    kw.update(extra)
    return GQConfig(dataset="synthetic", num_users=8, batch_size=32,
                    quantizer=quantizer, hsq_passes=1, **kw)


def check_encode(x, comp, passes, name):
    """Kernel vs plain encode; returns (u, codes, max_abs_err)."""
    import torch

    from gqx_torch.ops import hsq as hsq_ops
    from gqx_torch.ops.hsq_prep import bf16_round, split_hi_lo

    cb = comp.codebook(x.device)
    u_k, c_k = hsq_ops.hsq_encode_flat(x, cb, comp.dim, passes, comp.code_dtype)
    u_p, c_p = hsq_ops.hsq_encode_flat_plain(x, cb, comp.dim, passes, comp.code_dtype)
    torch.cuda.synchronize()
    differ = (c_k != c_p).reshape(-1)
    n_differ = int(differ.sum())
    if n_differ:
        # a code may differ only where the top two |p| are within 1e-5 |u|
        rows = x.reshape(-1, comp.dim)[differ].to(torch.float32)
        if passes == 1:
            p = bf16_round(rows) @ cb.t()
        else:
            hi, lo = split_hi_lo(rows)
            p = hi @ cb.t() + lo @ cb.t()
        top2 = p.abs().topk(2, dim=1).values
        margin = top2[:, 0] - top2[:, 1]
        worst = float((margin / top2[:, 0].clamp_min(1e-30)).max())
        if worst > 1e-5:
            raise AssertionError(f"{name}: {n_differ} codes differ, top-2 margin up to {worst}")
    same = ~differ
    uk, up = u_k.reshape(-1)[same], u_p.reshape(-1)[same]
    err = (uk - up).abs()
    if not bool((err <= 1e-6 * up.abs() + 1e-30).all()):
        raise AssertionError(f"{name}: u differs by up to {float((err / up.abs().clamp_min(1e-30)).max())} relative")
    log(f"[{name}] codes differing on near-ties: {n_differ} of {c_k.numel()}; "
        f"max |u - u_plain| {float(err.max()):.3e}")
    return u_k, c_k, float(err.max())


def resnet50_plan(cfg, seed: int):
    """``cfg``'s unit plan of CIFAR ResNet-50."""
    import torch

    from gqx_torch.convert import leaf_paths
    from gqx_torch.models import create_model
    from gqx_torch.parallel.packing import plan_units

    model = create_model("resnet50", 10, "bfloat16", torch.Generator().manual_seed(seed))
    return plan_units([(n, tuple(p.shape)) for n, p in model.named_parameters()],
                      leaf_paths(model), cfg)


def hsq_unit(cfg, seed: int):
    """The HSQ unit of ``cfg``'s ResNet-50 plan."""
    unit = resnet50_plan(cfg, seed).units[0]
    comp = unit.compressor
    log(f"[unit] ResNet-50 HSQ unit (c_dim {cfg.c_dim}, k_bit {cfg.k_bit}): "
        f"{len(unit.sizes)} leaves, {unit.size} elements (pad {unit.pad}), "
        f"M={comp.M} subvectors of {comp.dim}, K={comp.K}, "
        f"{comp.norm_compressor.n_segments} norm segments, flat layout: {comp.flat_ok}")
    return unit


def unit_input(unit, users: int, seed: int):
    """Gradient-like float32 (users, unit.size) on the card: per-leaf scales
    spread over two decades, the pad zero as pack() makes it."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((users, unit.size), dtype=np.float32)).cuda()
    scales = torch.from_numpy(10.0 ** rng.uniform(-4, -2, len(unit.sizes) + 1).astype(np.float32))
    lengths = torch.tensor(list(unit.sizes) + [unit.pad])
    x *= torch.repeat_interleave(scales, lengths).cuda()
    x[:, sum(unit.sizes):] = 0.0
    return x


def encode_timing(label, x, comp, passes):
    """K1's device time (torch.profiler) and events at one shape, against its
    bound and its plain version; returns one shape's record."""
    import torch

    from gqx_torch.ops import hsq as hsq_ops

    cb = comp.codebook(x.device)
    rows, k = x.numel() // comp.dim, comp.K
    kernel = lambda: hsq_ops.hsq_encode_flat(x, cb, comp.dim, passes, comp.code_dtype)
    plain = lambda: hsq_ops.hsq_encode_flat_plain(x, cb, comp.dim, passes, comp.code_dtype)
    contractions = 2 if passes == 2 and x.dtype == torch.float32 else 1
    flop = 2.0 * rows * k * comp.dim * contractions
    code_bytes = torch.empty(0, dtype=comp.code_dtype).element_size()
    b_ms, b_by = bound(x.numel() * x.element_size() + rows * (4 + code_bytes) + k * comp.dim * 4,
                       flop, BF16_FLOPS)
    rec = dict(shape=label, rows=rows, ms=device_ms(kernel, 20), events_ms=cuda_ms(kernel, 20),
               plain_ms=device_ms(plain, 2), bound_ms=b_ms, bound_by=b_by)
    rec["tflops"] = flop / rec["ms"] * 1e-9
    log(f"[hsq_encode {label}] {rows} rows, {str(x.dtype)[6:]}, passes={passes}: "
        f"{rec['ms']:.4f} ms device time = {rec['tflops']:.1f} TFLOP/s (events {rec['events_ms']:.4f} "
        f"ms; bound {b_ms:.4f} ms by {b_by}), plain {rec['plain_ms']:.3f} ms")
    return rec


def encode_phase(comp, x32, xb, comp9, x9):
    """K1, the tensor-core encode, against its plain version and timed at the
    shapes the paths give it: P1 (bf16, passes=1, every user at once), P2
    (the float32 error-feedback units, passes=1), P3 (one user per hop: bf16
    at hop 0, float32 after), gqx's strict-parity passes=2 on P1's float32
    unit, and P9's HSQ stage (``comp9``: passes=2 on the unpadded float32
    unit ``x9``).  Returns (u, codes) at P1's and at P9's shape and the
    ``kernels`` entry, whose times are P1's."""
    u_k, c_k, err = check_encode(xb, comp, 1, "hsq_encode P1 bf16 passes=1")
    shapes = [encode_timing("P1", xb, comp, 1)]
    for label, x, passes in (("P2", x32, 1), ("P3 hop 0", xb[0], 1),
                             ("P3 later hops", x32[0], 1), ("P1 float32 passes=2", x32, 2)):
        _, _, e = check_encode(x, comp, passes, f"hsq_encode {label} {str(x.dtype)[6:]} "
                                                f"passes={passes}")
        err = max(err, e)
        shapes.append(encode_timing(label, x, comp, passes))
    u9, c9, e = check_encode(x9, comp9, 2, "hsq_encode P9 float32 passes=2")
    err = max(err, e)
    shapes.append(encode_timing("P9 float32 passes=2", x9, comp9, 2))
    p1 = shapes[0]
    entry = dict(
        name="hsq_encode", route="cuda", source="gqx_torch/csrc/hsq_encode.cu",
        engine="tensor cores: mma.sync m16n8k16 bf16 -> float32, selection from the accumulators",
        replaces="gqx/ops/pallas_hsq4.py:87", max_abs_err=err, ms=p1["ms"],
        events_ms=p1["events_ms"], plain_ms=p1["plain_ms"], bound_ms=p1["bound_ms"],
        bound_by=p1["bound_by"], library_ms=None, shapes=shapes)
    return (u_k, c_k), (u9, c9), entry


def kernel_phase(seed: int):
    """Each flat-layout kernel (and the uniforms) against its plain version
    at the canonical unit's shapes."""
    import torch
    import torch.nn.functional as F

    from gqx_torch.ops import hsq as hsq_ops
    from gqx_torch.ops import rand as rand_ops

    cfg = canonical_config()
    unit = hsq_unit(cfg, seed)
    comp = unit.compressor
    users, size, m, dim, k = cfg.num_users, unit.size, comp.M, comp.dim, comp.K
    dev = torch.device("cuda")
    x32 = unit_input(unit, users, seed)
    xb = x32.to(torch.bfloat16)
    cb = comp.codebook(dev)
    entries = {}

    # P9's HSQ stage: passes=2 on a float32 unit that is not padded (only HSQ
    # units are), so its last 65,536-element block is cut short
    unit9 = max(resnet50_plan(canonical_config(**PATHS["P9"][0]), seed).units,
                key=lambda u: u.size)
    comp9 = unit9.compressor.stages[0]
    x9 = unit_input(unit9, users, seed + 1)
    log(f"[unit] ResNet-50 Residual unit (P9): {unit9.size} elements (pad {unit9.pad}, "
        f"{unit9.size % 65536} past the last 65,536 block), HSQ stage passes={comp9.passes}, "
        f"M={comp9.M}, flat layout: {comp9.flat_ok}")

    # K1 at the shapes of the main paths, gqx's strict-parity passes=2, P9's
    (u_k, c_k), (u9, c9), entries["hsq_encode"] = encode_phase(comp, x32, xb, comp9, x9)

    # K3: the norm quantizer's uniforms for every user of the unit
    n = users * m
    r1 = rand_ops.uniform(12345, 0, (users, m), dev)
    r2 = rand_ops.uniform(12345, 0, (users, m), dev)
    rp = rand_ops.uniform_plain(12345, 0, (users, m), dev)
    torch.cuda.synchronize()
    if not torch.equal(r1, rp):
        raise AssertionError("philox_uniform: kernel and plain version differ")
    if not torch.equal(r1, r2):
        raise AssertionError("philox_uniform: same seed gave different values")
    mean = float(r1.double().mean())
    if abs(mean - 0.5) > 1e-3 or float(r1.min()) < 0.0 or float(r1.max()) >= 1.0:
        raise AssertionError(f"philox_uniform: mean {mean}, range [{float(r1.min())}, {float(r1.max())}]")
    if rand_ops.uniform(1, 0, (0,), dev).numel() != 0:
        raise AssertionError("philox_uniform: n=0 must give an empty tensor")
    log(f"[philox_uniform] bit-equal to plain; mean {mean:.6f}")
    gen = torch.Generator(device=dev).manual_seed(seed)
    b, by = bound(n * 4, n * 33.0, FP32_FLOPS)
    # device time (torch.profiler), CUDA events beside it
    kernel = lambda: rand_ops.uniform(7, 0, (users, m), dev)
    library = lambda: torch.rand((users, m), generator=gen, device=dev)
    entries["philox_uniform"] = e = dict(
        name="philox_uniform", route="cuda", source="gqx_torch/csrc/philox_uniform.cu",
        replaces="gqx/ops/pallas_rand.py:129", max_abs_err=0.0,
        ms=device_ms(kernel, 20), events_ms=cuda_ms(kernel, 20),
        plain_ms=device_ms(lambda: rand_ops.uniform_plain(7, 0, (users, m), dev), 3),
        bound_ms=b, bound_by=by, library_ms=device_ms(library, 20),
        library_events_ms=cuda_ms(library, 20))
    log(f"[philox_uniform] {n} values: {e['ms']:.4f} ms device time (events {e['events_ms']:.4f} "
        f"ms; bound {b:.4f} ms by {by}), library (torch.rand) {e['library_ms']:.4f} ms (events "
        f"{e['library_events_ms']:.4f} ms)")

    # K2 on the signature the main path hands it: codes from K1, u dequantized
    norm = comp.norm_compressor
    u_q = norm.decompress(norm.compress(u_k, torch.Generator().manual_seed(seed))).contiguous()
    # 1e-6 relative to the magnitude of the summed terms: only the order of
    # the (at most U) fp32 additions differs from the plain version
    tol = 1e-6 * hsq_ops.hsq_decode_mean_plain(c_k, u_q.abs(), cb.abs(), dim, 2)
    for passes in (2, 1):
        d_k = hsq_ops.hsq_decode_mean(c_k, u_q, cb, dim, passes)
        d_p = hsq_ops.hsq_decode_mean_plain(c_k, u_q, cb, dim, passes)
        torch.cuda.synchronize()
        err = (d_k - d_p).abs()
        if not bool((err <= tol).all()):
            raise AssertionError(f"hsq_decode_mean passes={passes}: max abs err "
                                 f"{float(err.max())}, {int((err > tol).sum())} beyond 1e-6 relative")
        log(f"[hsq_decode_mean passes={passes}] max |out - plain| {float(err.max()):.3e}")
    sorted_codes = c_k.long().sort(dim=0).values
    distinct = int(m + (sorted_codes[1:] != sorted_codes[:-1]).sum())
    codes_t = c_k.t().long().contiguous()
    w_t = (u_q.t() / users).contiguous()
    b, by = bound(users * m * 5 + m * dim * 4 + k * dim * 4, 2.0 * distinct * dim, FP32_FLOPS)
    # device time (torch.profiler), CUDA events beside it
    kernel = lambda: hsq_ops.hsq_decode_mean(c_k, u_q, cb, dim, 1)
    library = lambda: F.embedding_bag(codes_t, cb, per_sample_weights=w_t, mode="sum")
    entries["hsq_decode_mean"] = dict(
        name="hsq_decode_mean", route="cuda", source="gqx_torch/csrc/hsq_decode_mean.cu",
        replaces="gqx/ops/pallas_hsq4.py:252", max_abs_err=float(err.max()),
        ms=device_ms(kernel, 20), events_ms=cuda_ms(kernel, 20),
        plain_ms=device_ms(lambda: hsq_ops.hsq_decode_mean_plain(c_k, u_q, cb, dim, 1), 2),
        bound_ms=b, bound_by=by, library_ms=device_ms(library, 20),
        library_events_ms=cuda_ms(library, 20))
    e = entries["hsq_decode_mean"]
    log(f"[hsq_decode_mean] {users} users x {m} subvectors of {dim}, passes=1: {e['ms']:.4f} ms "
        f"device time (events {e['events_ms']:.4f} ms; bound {b:.4f} ms by {by}), plain "
        f"{e['plain_ms']:.3f} ms, library (embedding_bag) {e['library_ms']:.4f} ms "
        f"(events {e['library_events_ms']:.4f} ms)")
    # K4 on the same signature: all users at once (the users' round trip with
    # error feedback) and one user (the server's recompression, a ring hop)
    err4 = 0.0
    for passes in (1, 2):
        for c, v in ((c_k, u_q), (c_k[0], u_q[0]), (c_k.to(torch.int32), u_q)):
            d_k = hsq_ops.hsq_decode_flat(c, v, cb, dim, passes)
            d_p = hsq_ops.hsq_decode_plain(c, v, cb, dim, passes)
            torch.cuda.synchronize()
            if d_k.shape != c.shape[:-1] + (size,) or not torch.equal(d_k, d_p):
                raise AssertionError(
                    f"hsq_decode passes={passes} {tuple(c.shape)} {c.dtype}: not bit-equal to "
                    f"plain, max abs err {float((d_k - d_p).abs().max())}")
            err4 = max(err4, float((d_k - d_p).abs().max()))
            del d_k, d_p
    # and P9's: passes=2 on the unpadded unit, the signature its encode made
    norm9 = comp9.norm_compressor
    u9_q = norm9.decompress(norm9.compress(u9, torch.Generator().manual_seed(seed))).contiguous()
    cb9 = comp9.codebook(dev)
    for c, v in ((c9, u9_q), (c9[0], u9_q[0]), (c9.to(torch.int32), u9_q)):
        d_k = hsq_ops.hsq_decode_flat(c, v, cb9, comp9.dim, 2)
        d_p = hsq_ops.hsq_decode_plain(c, v, cb9, comp9.dim, 2)
        torch.cuda.synchronize()
        if d_k.shape != c.shape[:-1] + (unit9.size,) or not torch.equal(d_k, d_p):
            raise AssertionError(
                f"hsq_decode P9 {tuple(c.shape)} {c.dtype}: not bit-equal to plain, max abs "
                f"err {float((d_k - d_p).abs().max())}")
        del d_k, d_p
    log("[hsq_decode] bit-equal to plain at U=8 and U=1, uint8 and int32 codes, passes 1 and 2; "
        f"at P9's unpadded unit of {unit9.size}, passes=2, U=8 and U=1, uint8 and int32 codes")
    p9_ms = device_ms(lambda: hsq_ops.hsq_decode_flat(c9, u9_q, cb9, comp9.dim, 2), 20)
    log(f"[hsq_decode P9] {users} users x {comp9.M} subvectors, passes=2: {p9_ms:.4f} ms "
        "device time")
    del x9, u9, c9, u9_q
    one_ms = cuda_ms(lambda: hsq_ops.hsq_decode_flat(c_k[0], u_q[0], cb, dim, 1), 20)
    log(f"[hsq_decode U=1] {one_ms:.4f} ms")
    codes_col = c_k.reshape(-1, 1).long()
    w_col = u_q.to(torch.bfloat16).to(torch.float32).reshape(-1, 1)
    b, by = bound(users * m * 5 + users * size * 4 + k * dim * 4, 1.0 * users * size, FP32_FLOPS)
    # device time (torch.profiler), CUDA events beside it
    kernel = lambda: hsq_ops.hsq_decode_flat(c_k, u_q, cb, dim, 1)
    library = lambda: F.embedding_bag(codes_col, cb, per_sample_weights=w_col, mode="sum")
    entries["hsq_decode"] = e = dict(
        name="hsq_decode", route="cuda", source="gqx_torch/csrc/hsq_decode.cu",
        replaces="gqx/ops/pallas_hsq4.py:191, gqx/ops/pallas_hsq3.py:253",
        max_abs_err=err4, ms=device_ms(kernel, 20), events_ms=cuda_ms(kernel, 20),
        plain_ms=device_ms(lambda: hsq_ops.hsq_decode_plain(c_k, u_q, cb, dim, 1), 3),
        bound_ms=b, bound_by=by, library_ms=device_ms(library, 5),
        library_events_ms=cuda_ms(library, 5))
    log(f"[hsq_decode] {users} users x {m} subvectors of {dim}: {e['ms']:.4f} ms device time "
        f"(events {e['events_ms']:.4f} ms; bound {b:.4f} ms by {by}), library (embedding_bag) "
        f"{e['library_ms']:.4f} ms (events {e['library_events_ms']:.4f} ms)")
    return entries


def check_rows_encode(rows, cb, code_dtype, name, route):
    """Row-major kernel vs plain encode; returns (u, codes, max_abs_err).
    The two sum the dim fp32 products in different orders: a code may
    differ only where the top two |p| are within 1e-5 relative, and u may
    differ by 1e-6 of the summed magnitudes |x| . |c|.  The launch must
    take ``route``."""
    import torch

    from gqx_torch.ops import hsq_rows

    before = dict(hsq_rows.launches_by_route)
    u_k, c_k = hsq_rows.hsq_encode(rows, cb, code_dtype)
    moved = {key: v - before[key] for key, v in hsq_rows.launches_by_route.items()}
    if moved[route] != 1 or sum(moved.values()) != 1:
        raise AssertionError(f"{name}: launches by route {moved}, expected 1 on {route}")
    u_p, c_p = hsq_rows.hsq_encode_plain(rows, cb, code_dtype)
    torch.cuda.synchronize()
    flat = rows.reshape(-1, rows.shape[-1]).float()
    differ = (c_k != c_p).reshape(-1)
    n_differ = int(differ.sum())
    if n_differ:
        top2 = (flat[differ] @ cb.t()).abs().topk(2, dim=1).values
        worst = float(((top2[:, 0] - top2[:, 1]) / top2[:, 0].clamp_min(1e-30)).max())
        if worst > 1e-5:
            raise AssertionError(f"{name}: {n_differ} codes differ, top-2 margin up to {worst}")
    same = ~differ
    err = (u_k.reshape(-1) - u_p.reshape(-1)).abs()[same]
    mag = torch.empty_like(u_p.reshape(-1))
    for s0 in range(0, flat.shape[0], 1 << 20):   # |x| . |c[code]| per row, in blocks
        blk = slice(s0, s0 + (1 << 20))
        mag[blk] = (flat[blk].abs() * cb.abs()[c_p.reshape(-1)[blk].long()]).sum(1)
    if not bool((err <= 1e-6 * mag[same] + 1e-30).all()):
        raise AssertionError(f"{name}: u differs by up to {float(err.max())}")
    log(f"[{name}] route {route}: codes differing on near-ties: {n_differ} of {c_k.numel()}; "
        f"max |u - u_plain| {float(err.max()):.3e}")
    return u_k, c_k, float(err.max())


def rows_timing(label, rows, cb, code_dtype):
    """K6 encode's device time (torch.profiler) and events at one shape,
    against its bound and its plain version; returns the shape's record.
    The bound counts the operations of the route: on the tensor cores (both
    routes) the exact bf16 pieces' passes (three for bf16 rows, six for
    float32) at the bf16 peak; one fp32 multiply-add per product, the CUDA
    cores' bound, is kept beside (``fp32_fma_bound_ms``)."""
    import torch

    from gqx_torch.ops import hsq_rows

    dim, k = rows.shape[-1], cb.shape[0]
    n = rows.numel() // dim
    which = hsq_rows.route(rows.dtype, dim)
    macs = float(n) * k * dim
    code_bytes = torch.empty(0, dtype=code_dtype).element_size()
    moved = rows.numel() * rows.element_size() + n * (4 + code_bytes) + k * dim * 4
    fma_ms, _ = bound(moved, 2.0 * macs, FP32_FLOPS)
    passes = 3 if rows.dtype == torch.bfloat16 else 6
    b_ms, b_by = bound(moved, 2.0 * passes * macs, BF16_FLOPS)
    kernel = lambda: hsq_rows.hsq_encode(rows, cb, code_dtype)
    rec = dict(shape=label, route=which, rows=n, ms=device_ms(kernel, 10),
               events_ms=cuda_ms(kernel, 10),
               plain_ms=device_ms(lambda: hsq_rows.hsq_encode_plain(rows, cb, code_dtype), 1),
               bound_ms=b_ms, bound_by=b_by, fp32_fma_bound_ms=fma_ms)
    log(f"[hsq_rows_encode {label}] {n} rows of {dim}, K {k}, {str(rows.dtype)[6:]}, route "
        f"{which}: {rec['ms']:.4f} ms device time (events {rec['events_ms']:.4f} ms; bound "
        f"{b_ms:.4f} ms by {b_by}, {100 * b_ms / rec['ms']:.1f}% of it; fp32 FMA bound "
        f"{fma_ms:.4f} ms), plain {rec['plain_ms']:.3f} ms")
    return rec


def wide_rows_compressor(seed: int):
    """P6's compressor: HSQ c_dim 256 / k_bit 8 for the gradient unit of
    P1's plan (23,527,424 elements: 91,904 rows of 256, K = 256, P8's
    shape); returns (unit, compressor)."""
    from gqx_torch.compress import make_compressor

    unit = hsq_unit(canonical_config(), seed)
    comp = make_compressor("hsq", unit.size, (unit.size,), canonical_config(**WIDE_ROWS[0]))
    if comp.flat_ok or (comp.dim, comp.K) != (256, 256):
        raise AssertionError(f"P6's compressor is dim {comp.dim}, K {comp.K}, flat {comp.flat_ok}")
    return unit, comp


def wide_rows_path(seed: int):
    """P6: one compress_batch and one decode_mean of 8 users' bf16 gradient
    unit at c_dim 256 on the card, the launch counters set to 0 just before
    and read just after; the mean against the CPU plain path from the same
    input and seed (subvectors differing on near-tie codes or level
    boundaries: at most 1e-3 of them).  Returns the launches."""
    import torch

    unit, comp = wide_rows_compressor(seed)
    users = canonical_config().num_users
    g = unit_input(unit, users, seed + 6).to(torch.bfloat16)
    counters(reset=True)
    mean = comp.decode_mean(comp.compress_batch(g, torch.Generator().manual_seed(seed)))
    torch.cuda.synchronize()
    launches = counters()
    for kernel, count in launches.items():
        if count != WIDE_ROWS[1].get(kernel, 0):
            raise AssertionError(f"P6: {kernel} launched {count} times, expected "
                                 f"{WIDE_ROWS[1].get(kernel, 0)}")
    want = comp.decode_mean(comp.compress_batch(g.cpu(), torch.Generator().manual_seed(seed)))
    if not bool(torch.isfinite(mean).all()) or mean.shape != (unit.size,):
        raise AssertionError(f"P6: mean of shape {tuple(mean.shape)}, finite "
                             f"{bool(torch.isfinite(mean).all())}")
    bad = _subvectors_off(mean.cpu(), want, comp.dim)
    log(f"[slice P6] HSQ c_dim 256 / k_bit 8, {users} users x {comp.M} rows of {comp.dim}, "
        f"compress_batch + decode_mean: launches {launches}; {bad} of {comp.M} subvectors of the "
        "mean differ from the CPU plain path")
    if bad > 1e-3 * comp.M:
        raise AssertionError(f"P6: {bad} subvectors differ from the CPU plain path")
    return launches


def rows_kernel_phase(seed: int):
    """The row-major encode and decode against their plain versions: the
    encode's tensor-core route at the shape of P4's unit (8 users x 2.94M
    rows, dim 8, K=1024) on bf16 rows (P4's unit) and float32 rows (the
    unit with error feedback), its wide route at P6's and P8's (8 users x
    91,904 rows of 256, K=256), both input types, with hsq_rows_encode.cu,
    the CUDA-core kernel it replaced, checked (u bit-equal where the codes
    agree) and timed beside it; then ragged dims (5, 24, 36, 576), dims 32
    and 512, and codebooks larger than shared memory or a codeword tile
    (dim 16 x K 4096 = 256 KB; dim 32 x K 1024 in pieces; dim 576 x K
    1024)."""
    import os

    import numpy as np
    import torch
    import torch.nn.functional as F

    from gqx_torch.codebooks import DEFAULT_DIR, codebook_filename, get_codebook
    from gqx_torch.ops import hsq_rows
    from gqx_torch.scripts.rows_wide_probe import cuda_core_encode

    cfg = canonical_config(**PATHS["P4"][0])
    unit = hsq_unit(cfg, seed)
    comp = unit.compressor
    users, m, dim, k = cfg.num_users, comp.M, comp.dim, comp.K
    if comp.flat_ok or (dim, k) != (8, 1024):
        raise AssertionError(f"P4's unit is dim {dim}, K {k}, flat layout {comp.flat_ok}")
    dev = torch.device("cuda")
    rows32 = unit_input(unit, users, seed + 1).reshape(users, m, dim)
    cb = comp.codebook(dev)
    entries, shapes, err = {}, [], 0.0
    for label, rows in (("P4 bf16", rows32.to(torch.bfloat16)),
                        ("P4 float32 (error feedback)", rows32)):
        u_r, c_r, e = check_rows_encode(rows, cb, comp.code_dtype,
                                        f"hsq_rows_encode {label} dim 8 K 1024",
                                        hsq_rows.TENSOR_CORE)
        err = max(err, e)
        shapes.append(rows_timing(label, rows, cb, comp.code_dtype))
        if rows.dtype == torch.bfloat16:
            u_k, c_k = u_r, c_r          # the decode's input: P4's own signature
        del rows, u_r, c_r
    del rows32
    p4 = shapes[0]
    entries["hsq_rows_encode_tc"] = dict(
        name="hsq_rows_encode_tc", route="cuda", source="gqx_torch/csrc/hsq_rows_encode_tc.cu",
        engine="tensor cores: mma.sync m16n8k16 / m16n8k8 bf16 -> float32 on exact bf16 pieces "
               "of the float32 values, selection from the accumulators",
        replaces="gqx/ops/pallas_hsq.py:53", max_abs_err=err, ms=p4["ms"],
        events_ms=p4["events_ms"], plain_ms=p4["plain_ms"], bound_ms=p4["bound_ms"],
        bound_by=p4["bound_by"], fp32_fma_bound_ms=p4["fp32_fma_bound_ms"], library_ms=None,
        shapes=shapes)

    # decode on the signature the main path hands it: u dequantized
    norm = comp.norm_compressor
    u_q = norm.decompress(norm.compress(u_k, torch.Generator().manual_seed(seed))).contiguous()
    d_k = hsq_rows.hsq_decode(c_k, u_q, cb)
    d_p = hsq_rows.hsq_decode_plain(c_k, u_q, cb)
    torch.cuda.synchronize()
    if d_k.shape != (users, m, dim) or not torch.equal(d_k, d_p):
        raise AssertionError("hsq_rows_decode: not bit-equal to plain, max abs err "
                             f"{float((d_k - d_p).abs().max())}")
    log("[hsq_rows_decode dim 8 K 1024] bit-equal to plain")
    del d_k, d_p
    codes_col = c_k.reshape(-1, 1).long()
    w_col = u_q.reshape(-1, 1)
    # the decode reads each distinct code's codebook row once
    b, by = bound(users * m * 8 + users * m * dim * 4 + int(c_k.unique().numel()) * dim * 4,
                  1.0 * users * m * dim, FP32_FLOPS)
    # device time (torch.profiler), CUDA events beside it
    kernel = lambda: hsq_rows.hsq_decode(c_k, u_q, cb)
    library = lambda: F.embedding_bag(codes_col, cb, per_sample_weights=w_col, mode="sum")
    entries["hsq_rows_decode"] = e = dict(
        name="hsq_rows_decode", route="cuda", source="gqx_torch/csrc/hsq_rows_decode.cu",
        replaces="gqx/ops/pallas_hsq.py:119", max_abs_err=0.0,
        ms=device_ms(kernel, 20), events_ms=cuda_ms(kernel, 20),
        plain_ms=device_ms(lambda: hsq_rows.hsq_decode_plain(c_k, u_q, cb), 3),
        bound_ms=b, bound_by=by, library_ms=device_ms(library, 5),
        library_events_ms=cuda_ms(library, 5))
    log(f"[hsq_rows_decode] {users} users x {m} rows of {dim}: {e['ms']:.4f} ms device time "
        f"(events {e['events_ms']:.4f} ms; bound {b:.4f} ms by {by}), library (embedding_bag) "
        f"{e['library_ms']:.4f} ms (events {e['library_events_ms']:.4f} ms)")
    del codes_col, w_col, u_k, c_k, u_q

    # the wide route at P6's and P8's shape: rows of 256, bf16 (as P6 and P8
    # get them) and float32, with the CUDA-core kernel it replaced beside it
    unit6, comp6 = wide_rows_compressor(seed)
    cb6 = comp6.codebook(dev)
    rows32 = unit_input(unit6, users, seed + 4).reshape(users, comp6.M, comp6.dim)
    shapes, err = [], 0.0
    for label, rows in (("P6 bf16", rows32.to(torch.bfloat16)), ("P6 float32", rows32)):
        u_w, c_w, e = check_rows_encode(rows, cb6, comp6.code_dtype,
                                        f"hsq_rows_encode {label} dim 256 K 256",
                                        hsq_rows.TENSOR_CORE_WIDE)
        err = max(err, e)
        rec = rows_timing(label, rows, cb6, comp6.code_dtype)
        # the parent kernel: u bit-equal wherever the codes agree
        u_c, c_c = cuda_core_encode(rows, cb6, comp6.code_dtype)
        agree = c_c == c_w
        if not torch.equal(u_c[agree].view(torch.int32), u_w[agree].view(torch.int32)):
            raise AssertionError(f"hsq_rows_encode {label}: u differs from hsq_rows_encode.cu's "
                                 "where the codes agree")
        # timed by CUDA events around its launches: torch.profiler's windows
        # came back without its device time (a 20 ms kernel; the events'
        # host share is negligible)
        rec["cuda_core_events_ms"] = cuda_ms(
            lambda: cuda_core_encode(rows, cb6, comp6.code_dtype), 3)
        log(f"[hsq_rows_encode {label}] hsq_rows_encode.cu (CUDA cores, the route replaced): "
            f"{rec['cuda_core_events_ms']:.4f} ms by events; codes agree on {int(agree.sum())} of "
            f"{agree.numel()}, u bit-equal there")
        shapes.append(rec)
        del rows, u_w, c_w, u_c, c_c, agree
    del rows32
    p6 = shapes[0]
    entries["hsq_rows_encode_wide"] = dict(
        name="hsq_rows_encode_wide", route="cuda", source="gqx_torch/csrc/hsq_rows_encode_wide.cu",
        engine="tensor cores: wgmma m64n128k16 bf16 -> float32 on exact bf16 pieces, two "
               "accumulator sets, argmax epilogue; codebook chunks by bulk copy",
        replaces="gqx/ops/pallas_hsq.py:53", max_abs_err=err, ms=p6["ms"],
        events_ms=p6["events_ms"], plain_ms=p6["plain_ms"], bound_ms=p6["bound_ms"],
        bound_by=p6["bound_by"], fp32_fma_bound_ms=p6["fp32_fma_bound_ms"], library_ms=None,
        cuda_core_events_ms=p6["cuda_core_events_ms"],
        shapes=shapes)

    # ragged dims (5 and 24 zero-padded in the tensor-core fragments, 36 and
    # 576 in the wide route's chunks), dims 32 and 512, and codebooks in
    # several shared-memory K-tiles or codeword tiles; codebooks the repo has
    # no file for (7 codewords, dim 576) are random unit vectors
    rng = np.random.default_rng(seed + 2)
    for d, kk, n in ((5, 7, 200_000), (24, 256, 200_000), (32, 1024, 100_000),
                     (36, 64, 50_000), (16, 4096, 200_000), (512, 256, 50_000),
                     (576, 1024, 20_000)):
        if not os.path.exists(os.path.join(DEFAULT_DIR, codebook_filename(d, kk))):
            cb_np = rng.standard_normal((kk, d)).astype(np.float32)
            cb_np /= np.linalg.norm(cb_np, axis=1, keepdims=True)
        else:
            cb_np = get_codebook(d, kk)
        cb_s = torch.from_numpy(cb_np).to(dev)
        rows_s = torch.from_numpy(rng.standard_normal((2, n, d), dtype=np.float32)).to(dev)
        dt = torch.uint8 if kk <= 256 else torch.int32
        for x in (rows_s.to(torch.bfloat16), rows_s):
            which = hsq_rows.route(x.dtype, d)
            name = f"hsq_rows_encode dim {d} K {kk} {str(x.dtype)[6:]}"
            u_s, c_s, _ = check_rows_encode(x, cb_s, dt, name, which)
            if not torch.equal(hsq_rows.hsq_decode(c_s, u_s, cb_s),
                               hsq_rows.hsq_decode_plain(c_s, u_s, cb_s)):
                raise AssertionError(f"hsq_rows_decode dim {d} K {kk}: not bit-equal to plain")
            log(f"[{name}] {device_ms(lambda: hsq_rows.hsq_encode(x, cb_s, dt), 5):.4f} ms "
                f"device time for {2 * n} rows; decode bit-equal to plain")
    return entries


def dw_kernel_phase(seed: int):
    """The per-user conv weight gradient against its plain version, at 8
    users x 32 images, at every geometry of the stride-1 same-size convs of
    the networks of DW_NETWORKS (``dw_convs``): in bf16 those of ResNet-50,
    VGG-16 and DenseNet-BC (the 3-channel stems take the narrow kernel, the
    others the tensor-core kernel, as the per-route counters must show:
    among them VGG-16's 2x2 planes and DenseNet-BC's 48 -> 12 bottlenecks,
    12 of a 64-row channel tile), in float32 those of ResNet-18, ResNet-50,
    VGG-16 and DenseNet-BC (the stems on the narrow float32 kernel, the
    others on the float32 tensor-core kernel, with per_user_dw.cu, the
    CUDA-core kernel both replaced, checked and timed beside each), then odd
    ones: the stem's 3 channels in float32 with an
    even window and uneven pads (narrow float32); a 5x5 window with uneven
    pads on a 7x9 plane with ragged channel tiles (float32 and bf16 tensor
    cores); 15 channels under a 7x7
    window on rows of 70 (735 columns, 23 column tiles) and one channel
    under a 3x7 window with pads (2, 5) on a 9x7 plane (narrow).

    Tolerance: kernel and plain version add the same float32 products (exact
    for bf16 operands) in different orders, so they may differ by
    sqrt(n) * 2^-23 of the summed magnitudes, n = B*H*W terms per sum.

    Bound: the operations the route runs at the card's peak for their type
    (the float32 tensor-core route's six bf16 passes at the bf16 peak), or
    the bytes; for float32 the fp32 FMA bound is kept beside
    (``fp32_fma_bound_ms``).

    Returns one entry per route, and one for per_user_dw.cu at the float32
    stem (``baseline_of`` the narrow float32 route; no path launches it);
    its times are per training step: each
    geometry's time weighted by how many convs of the step have it (a
    ResNet-50 bf16 step for the tensor-core and narrow routes, a ResNet-50
    float32 step, P7's, for the float32 routes).  The bf16 tensor-core
    entry also holds the whole bf16 step of each network (``bf16_steps``),
    the float32 tensor-core entry the whole float32 step of each
    (``float32_steps``, with per_user_dw.cu on every conv beside it), every
    route together.  They are device times
    from torch.profiler, CUDA events beside them.  ``library_ms`` is the one
    PyTorch call that computes every user's gradient (``conv2d_weight`` with
    groups = U on the users folded into the channels, float32 without TF32
    for float32 inputs); the U per-user calls are timed beside it."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from gqx_torch.ops import dw as dw_ops
    from gqx_torch.scripts.dw_f32_probe import cuda_core_dw

    dev = torch.device("cuda")
    users, batch = 8, 32
    rng = np.random.default_rng(seed + 3)

    def make(ci, co, h, w, dtype, n=users * batch):
        x = torch.from_numpy(rng.standard_normal((n, ci, h, w), dtype=np.float32)).to(dev, dtype)
        dy = torch.from_numpy(rng.standard_normal((n, co, h, w), dtype=np.float32)).to(dev, dtype)
        return x, dy * 1e-3

    def check(x, dy, u, kh, kw, ph, pw, name):
        want_route = dw_ops.route(x.dtype, x.shape[1], kw)
        before = dict(dw_ops.launches_by_route)
        got = dw_ops.per_user_dw(x, dy, u, kh, kw, ph, pw)
        again = dw_ops.per_user_dw(x, dy, u, kh, kw, ph, pw)
        routed = {k: v - before[k] for k, v in dw_ops.launches_by_route.items()}
        if routed[want_route] != 2 or sum(routed.values()) != 2:
            raise AssertionError(f"per_user_dw {name}: launches by route {routed}, "
                                 f"expected 2 on {want_route}")
        want = dw_ops.per_user_dw_plain(x, dy, u, kh, kw, ph, pw)
        mag = dw_ops.per_user_dw_plain(x.abs(), dy.abs(), u, kh, kw, ph, pw)
        torch.cuda.synchronize()
        n = x.shape[0] // u * x.shape[2] * x.shape[3]
        err = (got - want).abs()
        if got.shape != want.shape or not bool((err <= n ** 0.5 * 2.0 ** -23 * mag + 1e-30).all()):
            raise AssertionError(f"per_user_dw {name}: max abs err {float(err.max())} beyond "
                                 f"sqrt({n}) * 2^-23 of the summed magnitudes")
        if not torch.equal(got, again):
            raise AssertionError(f"per_user_dw {name}: two runs gave different bits")
        rel = float((err / mag.clamp_min(1e-30)).max())
        log(f"[per_user_dw {name}] route {want_route}: max |out - plain| {float(err.max()):.3e} "
            f"({rel:.2e} of the summed magnitudes; allowed {n ** 0.5 * 2.0 ** -23:.2e}); "
            "two runs bit-equal")
        return want_route, float(err.max())

    def check_cuda_core(x, dy, u, name):
        """per_user_dw.cu where a float32 route runs, as it is timed beside
        it: within the same tolerance of the plain version.  Returns its
        largest error."""
        got = cuda_core_dw(x, dy, u, 3, 3, 1, 1)
        want = dw_ops.per_user_dw_plain(x, dy, u, 3, 3, 1, 1)
        mag = dw_ops.per_user_dw_plain(x.abs(), dy.abs(), u, 3, 3, 1, 1)
        n = x.shape[0] // u * x.shape[2] * x.shape[3]
        err = (got - want).abs()
        if not bool((err <= n ** 0.5 * 2.0 ** -23 * mag + 1e-30).all()):
            raise AssertionError(f"per_user_dw.cu {name}: beyond sqrt(n) * 2^-23 of the summed "
                                 "magnitudes")
        return float(err.max())

    def per_user_library(x, dy, u, kh, kw, ph, pw):
        xp = F.pad(x, (pw, kw - 1 - pw, ph, kh - 1 - ph))
        b = x.shape[0] // u
        shape = (dy.shape[1], x.shape[1], kh, kw)
        return torch.stack([torch.nn.grad.conv2d_weight(xp[i * b:(i + 1) * b], shape,
                                                        dy[i * b:(i + 1) * b]) for i in range(u)])

    def grouped_operands(x, dy, u, kh, kw, ph, pw):
        """x as (B, U*Ci, H + kh - 1, W + kw - 1), padded, and dy as
        (B, U*Co, H, W): the users folded into the channels, for one call
        with groups = U."""
        xp = F.pad(x, (pw, kw - 1 - pw, ph, kh - 1 - ph))
        fold = lambda t: t.reshape((u, -1) + t.shape[1:]).transpose(0, 1).reshape(
            (t.shape[0] // u, -1) + t.shape[2:]).contiguous()
        return fold(xp), fold(dy)

    def grouped_library(xg, dg, u, co, ci, kh, kw):
        return torch.nn.grad.conv2d_weight(xg, (u * co, ci, kh, kw), dg, groups=u).reshape(
            u, co, ci, kh, kw)

    keys = ("ms", "plain_ms", "library_ms", "per_user_library_ms", "bound_ms", "events_ms",
            "library_events_ms")
    routes = {r: dict(tot=dict.fromkeys(keys, 0.0), worst=0.0,
                      by={"bytes": 0.0, "operations": 0.0}, geometries=[])
              for r in (dw_ops.TENSOR_CORE, dw_ops.NARROW, dw_ops.TENSOR_CORE_F32,
                        dw_ops.NARROW_F32)}
    # the whole step of each network per dtype, every route together
    step_keys = {"bfloat16": ("ms", "library_ms", "per_user_library_ms", "plain_ms", "bound_ms",
                              "events_ms", "library_events_ms"),
                 "float32": ("ms", "cuda_core_ms", "library_ms", "plain_ms", "bound_ms",
                             "fp32_fma_bound_ms", "events_ms", "cuda_core_events_ms")}
    net_steps = {d: {net: dict.fromkeys(step_keys[d], 0.0) for net in nets}
                 for d, nets in DW_NETWORKS.items()}
    # the bound counts the operations the route runs: bf16 passes on the tensor
    # cores (six over the exact pieces of float32 values)
    passes = {dw_ops.TENSOR_CORE: 1, dw_ops.NARROW: 1, dw_ops.TENSOR_CORE_F32: 6,
              dw_ops.NARROW_F32: 6}
    baseline = None   # per_user_dw.cu at the float32 stem
    tf32 = torch.backends.cudnn.allow_tf32
    for dname, nets in DW_NETWORKS.items():
        dtype = getattr(torch, dname)
        size = 2 if dtype == torch.bfloat16 else 4
        geometries = {}   # (ci, co, h, w, kh, kw) -> {network: convs of a step}
        for net, network in nets.items():
            for geom, n in dw_convs(network).items():
                geometries.setdefault(geom, {})[net] = n
        # the library in float32 computes the same float32 products only without TF32
        torch.backends.cudnn.allow_tf32 = dtype != torch.float32
        try:
            for (ci, co, hh, ww, kh, kw), counts in geometries.items():
                ph, pw = (kh - 1) // 2, (kw - 1) // 2
                x, dy = make(ci, co, hh, ww, dtype)
                name = f"{ci}->{co} @{hh}x{ww} {dname}"
                which, err = check(x, dy, users, kh, kw, ph, pw, name)
                r = routes[which]
                r["worst"] = max(r["worst"], err)
                ref = dw_ops.per_user_dw_plain(x, dy, users, kh, kw, ph, pw)
                xg, dg = grouped_operands(x, dy, users, kh, kw, ph, pw)
                for label, lib in (("per user", per_user_library(x, dy, users, kh, kw, ph, pw)),
                                   ("grouped", grouped_library(xg, dg, users, co, ci, kh, kw))):
                    if not bool(((lib.float() - ref).abs() <= 2.0 ** -7 * ref.abs().max()).all()):
                        raise AssertionError(f"per_user_dw {name}: the library call ({label}) "
                                             "computes something else")
                del lib, ref
                flop = 2.0 * kh * kw * users * batch * hh * ww * ci * co
                moved = (x.numel() + dy.numel()) * size + users * co * ci * kh * kw * 4
                b_ms, b_by = bound(moved, passes[which] * flop, BF16_FLOPS)
                kernel = lambda: dw_ops.per_user_dw(x, dy, users, kh, kw, ph, pw)
                plain = lambda: dw_ops.per_user_dw_plain(x, dy, users, kh, kw, ph, pw)
                per_user = lambda: per_user_library(x, dy, users, kh, kw, ph, pw)
                grouped = lambda: grouped_library(xg, dg, users, co, ci, kh, kw)
                # device time (torch.profiler); the events' time per call beside it
                g = dict(shape=name, route=which, per_step=counts, bound_ms=b_ms, bound_by=b_by,
                         ms=device_ms(kernel, 20), plain_ms=device_ms(plain, 3),
                         library_ms=device_ms(grouped, 5), per_user_library_ms=device_ms(per_user, 5),
                         events_ms=cuda_ms(kernel, 20), library_events_ms=cuda_ms(grouped, 5))
                g["tflops"] = flop / g["ms"] * 1e-9
                g["of_bound"] = b_ms / g["ms"]
                extra = ""
                if dtype == torch.float32:
                    g["fp32_fma_bound_ms"], _ = bound(moved, flop, FP32_FLOPS)
                    # the same function on per_user_dw.cu, the kernel both routes replaced
                    cuda_core = lambda: cuda_core_dw(x, dy, users, kh, kw, ph, pw)
                    cuda_core_err = check_cuda_core(x, dy, users, name)
                    g["cuda_core_ms"] = device_ms(cuda_core, 10)
                    g["cuda_core_events_ms"] = cuda_ms(cuda_core, 10)
                    extra = (f"; per_user_dw.cu {g['cuda_core_ms']:.4f} ms (events "
                             f"{g['cuda_core_events_ms']:.4f}); fp32 FMA bound "
                             f"{g['fp32_fma_bound_ms']:.4f} ms")
                    if which == dw_ops.NARROW_F32 and baseline is None:
                        baseline = dict(g, route=dw_ops.CUDA_CORE, ms=g["cuda_core_ms"],
                                        events_ms=g["cuda_core_events_ms"],
                                        tflops=flop / g["cuda_core_ms"] * 1e-9,
                                        max_abs_err=cuda_core_err)
                for net, c in counts.items():
                    for key in step_keys[dname]:
                        net_steps[dname][net][key] += c * g[key]
                log(f"[per_user_dw {name}] route {which}: {g['ms']:.4f} ms = {g['tflops']:.1f} "
                    f"TFLOP/s (bound {b_ms:.4f} ms by {b_by}, {100 * g['of_bound']:.0f}%), plain "
                    f"{g['plain_ms']:.3f} ms, library "
                    f"(one conv2d_weight, groups={users}) {g['library_ms']:.4f} ms, (conv2d_weight "
                    f"per user) {g['per_user_library_ms']:.4f} ms; by events: kernel "
                    f"{g['events_ms']:.4f}, library {g['library_events_ms']:.4f} ms{extra}; "
                    f"x{counts} per step")
                r["geometries"].append(g)
                # the route's entry: per ResNet-50 step (P1's, or P7's in float32)
                count = counts.get("ResNet-50", 0)
                r["by"][b_by] += count * b_ms
                for key in r["tot"]:
                    r["tot"][key] += count * g[key]
                del x, dy, xg, dg
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
    for dname, steps in net_steps.items():
        for net, t in steps.items():
            convs = sum(dw_convs(DW_NETWORKS[dname][net]).values())
            f32 = (f"; all on per_user_dw.cu {t['cuda_core_ms']:.4f} ms; fp32 FMA bound "
                   f"{t['fp32_fma_bound_ms']:.4f} ms; per_user_dw.cu by events "
                   f"{t['cuda_core_events_ms']:.4f} ms" if dname == "float32" else
                   f"; per-user library calls {t['per_user_library_ms']:.4f} ms; library by "
                   f"events {t['library_events_ms']:.4f} ms")
            log(f"[per_user_dw per step] {net} {dname}, {convs} convs "
                f"{ {k: v for k, v in dw_per_step(DW_NETWORKS[dname][net], dname).items() if v} }, "
                f"device time: {t['ms']:.4f} ms (bound {t['bound_ms']:.4f} ms); library "
                f"(grouped conv2d_weight) {t['library_ms']:.4f} ms; plain {t['plain_ms']:.3f} ms; "
                f"by events: {t['events_ms']:.4f} ms{f32}")
    x, dy = make(3, 20, 32, 32, torch.float32, n=3 * 5)
    check(x, dy, 3, 2, 2, 0, 1, "3->20 @32x32 float32 2x2 pads (0,1)")
    x, dy = make(24, 70, 7, 9, torch.float32, n=2 * 7)
    check(x, dy, 2, 5, 5, 3, 1, "24->70 @7x9 float32 5x5 pads (3,1)")
    x, dy = make(24, 70, 7, 9, torch.bfloat16, n=2 * 7)
    check(x, dy, 2, 5, 5, 3, 1, "24->70 @7x9 bf16 5x5 pads (3,1)")
    x, dy = make(15, 70, 7, 70, torch.bfloat16, n=2 * 3)
    check(x, dy, 2, 7, 7, 3, 2, "15->70 @7x70 bf16 7x7 pads (3,2)")
    x, dy = make(1, 8, 9, 7, torch.bfloat16, n=4)
    check(x, dy, 1, 3, 7, 2, 5, "1->8 @9x7 bf16 3x7 pads (2,5)")
    sources = {dw_ops.TENSOR_CORE: ("per_user_dw_tc", "gqx_torch/csrc/per_user_dw_tc.cu"),
               dw_ops.NARROW: ("per_user_dw_narrow", "gqx_torch/csrc/per_user_dw_narrow.cu"),
               dw_ops.TENSOR_CORE_F32: ("per_user_dw_tc_f32",
                                        "gqx_torch/csrc/per_user_dw_tc_f32.cu"),
               dw_ops.NARROW_F32: ("per_user_dw_narrow_f32",
                                   "gqx_torch/csrc/per_user_dw_narrow_f32.cu")}
    entries = {}
    for which, (name, source) in sources.items():
        r = routes[which]
        entries[name] = dict(name=name, route="cuda", source=source,
                             replaces="gqx/ops/pallas_dw.py:128", max_abs_err=r["worst"],
                             bound_by=max(r["by"], key=r["by"].get),
                             geometries=r["geometries"], **r["tot"])
    entries["per_user_dw_tc"]["bf16_steps"] = net_steps["bfloat16"]
    tf = entries["per_user_dw_tc_f32"]
    tf["engine"] = ("tensor cores: mma.sync m16n8k16 bf16 -> float32 on exact bf16 pieces of the "
                    "float32 values, 6 of the 9 cross products, hh and the rest in two sets")
    tf["fp32_fma_bound_ms"] = sum(g["per_step"].get("ResNet-50", 0) * g["fp32_fma_bound_ms"]
                                  for g in tf["geometries"])
    tf["cuda_core_ms"] = sum(g["per_step"].get("ResNet-50", 0) * g["cuda_core_ms"]
                             for g in tf["geometries"])
    tf["float32_steps"] = net_steps["float32"]
    nf = entries["per_user_dw_narrow_f32"]
    nf["engine"] = ("tensor cores: mma.sync m16n8k16 bf16 -> float32 on exact bf16 pieces, 6 of "
                    "the 9 cross products in two sets; (ci, tap) columns, the pixels the depth")
    nf["cuda_core_ms"], nf["cuda_core_events_ms"] = baseline["ms"], baseline["events_ms"]
    # per_user_dw.cu, checked and timed at the float32 stem beside the route that replaced it
    entries["per_user_dw"] = dict(
        name="per_user_dw", route="cuda", source="gqx_torch/csrc/per_user_dw.cu",
        replaces="gqx/ops/pallas_dw.py:128", baseline_of="per_user_dw_narrow_f32",
        engine="CUDA cores: float32 FMAs", geometries=[baseline],
        **{k: baseline[k] for k in keys + ("bound_by", "max_abs_err")})
    return entries


def log_entries(entries):
    for e in entries.values():
        log(f"[{e['name']}] {e['ms']:.4f} ms (bound {e['bound_ms']:.4f} ms by {e['bound_by']}), "
            f"plain {e['plain_ms']:.3f} ms, library {e['library_ms']}")


def run_steps(cfg, seed: int, steps: int, count_fn=None):
    """Build ``cfg``'s model and take 1 + ``steps`` steps; returns
    (ms/step, losses, state, plan, step_fn, batch, launches)."""
    import numpy as np
    import torch

    from gqx_torch.models import create_model
    from gqx_torch.train import create_train_state, make_train_step

    model = create_model(cfg.network, cfg.num_classes, cfg.compute_dtype,
                         torch.Generator().manual_seed(seed))
    state, plan = create_train_state(cfg, model, device="cuda")
    train_step = make_train_step(cfg, plan)
    scale = cfg.ef_scale(EF_EPOCH)

    def step(state, x, y, lr, wd, gen):
        return train_step(state, x, y, lr, wd, gen, scale)

    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    h, w, c = model.image_shape
    x = torch.from_numpy(rng.standard_normal(
        (cfg.num_users, cfg.batch_size, c, h, w), dtype=np.float32)).to(dev)
    y = torch.from_numpy(rng.integers(0, 10, (cfg.num_users, cfg.batch_size))).to(dev)
    gen = torch.Generator().manual_seed(seed + 1)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    losses = [float(step(state, x, y, 0.1, 5e-4, gen))]   # warm-up
    if count_fn is not None:
        count_fn(reset=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = [step(state, x, y, 0.1, 5e-4, gen) for _ in range(steps)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / steps * 1e3
    launches = count_fn() if count_fn is not None else None
    losses += [float(v) for v in out]
    what = f"{cfg.network} {cfg.quantizer} {cfg.mode}"
    log(f"[memory {what}{'' if cfg.folded_users else ' loop'}] peak allocated "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{what}: non-finite loss {losses}")
    changed = sum(int(not torch.equal(before[n], p)) for n, p in model.named_parameters())
    if changed != len(before):
        raise AssertionError(f"{what}: only {changed} of {len(before)} parameters changed")
    finite = all(bool(torch.isfinite(p).all()) for p in model.parameters())
    if not finite:
        raise AssertionError(f"{what}: non-finite parameters")
    return ms, losses, state, plan, step, (x, y, gen), launches


def counters(reset=False):
    from gqx_torch.ops import dw as dw_ops
    from gqx_torch.ops import hsq as hsq_ops
    from gqx_torch.ops import hsq_rows
    from gqx_torch.ops import rand as rand_ops

    if reset:
        for table in (hsq_ops.launches, hsq_rows.launches, hsq_rows.launches_by_route):
            for key in table:
                table[key] = 0
        rand_ops.launches = 0
        dw_ops.launches = 0
        for key in dw_ops.launches_by_route:
            dw_ops.launches_by_route[key] = 0
        return None
    by_route = dw_ops.launches_by_route
    if dw_ops.launches != sum(by_route.values()):
        raise AssertionError(f"per_user_dw: {dw_ops.launches} launches, by route {by_route}")
    rows_route = hsq_rows.launches_by_route
    if hsq_rows.launches["hsq_rows_encode"] != sum(rows_route.values()):
        raise AssertionError(f"hsq_rows_encode: {hsq_rows.launches['hsq_rows_encode']} launches, "
                             f"by route {rows_route}")
    return {**hsq_ops.launches, "hsq_rows_decode": hsq_rows.launches["hsq_rows_decode"],
            "hsq_rows_encode_wide": rows_route[hsq_rows.TENSOR_CORE_WIDE],
            "hsq_rows_encode_tc": rows_route[hsq_rows.TENSOR_CORE],
            "philox_uniform": rand_ops.launches,
            "per_user_dw": by_route[dw_ops.CUDA_CORE], "per_user_dw_tc": by_route[dw_ops.TENSOR_CORE],
            "per_user_dw_narrow": by_route[dw_ops.NARROW],
            "per_user_dw_tc_f32": by_route[dw_ops.TENSOR_CORE_F32],
            "per_user_dw_narrow_f32": by_route[dw_ops.NARROW_F32]}


def check_launches(name, cfg, plan, steps, launches, per_unit, entries):
    """``steps`` steps' launches against what the code implies: per
    compressed unit and step as ``per_unit`` says ("U": once per user), the
    conv weight gradient per folded step by route, from the network's convs
    and the compute dtype (``dw_per_step``), none of any other
    kernel; each count joins its kernel's entry under ``name``."""
    units = sum(1 for u in plan.units if type(u.compressor).__name__ != "IdenticalCompressor")
    dw_table = dw_per_step(cfg.network, cfg.compute_dtype)
    for kernel, count in launches.items():
        n = per_unit.get(kernel, 0)
        want = steps * units * (cfg.num_users if n == "U" else n)
        if kernel in dw_table:
            want = steps * dw_table[kernel] if cfg.folded_users else 0
        if count != want:
            raise AssertionError(f"{name}: {kernel} launched {count} times in "
                                 f"{steps} steps, expected {want}")
        entries[kernel]["launches"] += count
        entries[kernel]["launches_by_path"][name] = count


def per_user_grads(cfg, state, plan, x, y):
    """The per-user gradients as ``cfg``'s train step computes them."""
    from gqx_torch.train import folded_user_grads, user_grads

    if cfg.folded_users:
        return folded_user_grads(state.model, plan, plan.names, x, y)
    return user_grads(state.model, plan.names, x, y)


def device_profile(state, step, batch, ms_step, top: int = 10):
    """Device time of one step from torch.profiler (CUDA activity): the sum
    of kernel self times, its share of the unprofiled step time, and the
    ``top`` kernels that take most of it.  Returns the device ms (None
    where the window showed none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    x, y, gen = batch
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pad_window()
        step(state, x, y, 0.1, 5e-4, gen)
        torch.cuda.synchronize()
    rows, pads = device_rows(prof)
    device_ms = sum(r[0] for r in rows) / 1e3
    if device_ms == 0.0 or not pads:
        log(f"[profile] the profiler showed {pads} of its {PAD_CALLS} leading spin kernels and "
            f"{device_ms} ms of device time: device busy share not measured")
        return None
    log(f"[profile] device kernel time {device_ms:.2f} ms per step = "
        f"{100 * device_ms / ms_step:.1f}% of the {ms_step:.2f} ms step; "
        f"{sum(r[1] for r in rows)} kernel launches per step")
    for t, n, key in sorted(rows, reverse=True)[:top]:
        log(f"[profile]   {t / 1e3:8.3f} ms  x{n:<5d} {key[:90]}")
    return device_ms


def device_split_phase(name, state, step, batch, ms_step):
    """A step's device time split by family as ``gqx_torch.bench`` splits
    it (3 profiled steps); the families must sum to the device total
    within 1%."""
    from gqx_torch import bench

    x, y, gen = batch
    total, split, by_op = bench.device_split(lambda: step(state, x, y, 0.1, 5e-4, gen),
                                             state.model, 3)
    attributed = sum(v for k, v in split.items() if k != bench.UNATTRIBUTED)
    if abs(attributed - total) > 0.01 * total:
        raise AssertionError(f"{name}: the families {split} sum to {attributed} ms, the device "
                             f"total is {total} ms")
    log(f"[split {name}] device {total:.2f} ms a step ({100 * total / ms_step:.1f}% of the "
        f"{ms_step:.2f} ms step): " + json.dumps({k: round(v, 3) for k, v in
                                                   sorted(split.items(), key=lambda kv: -kv[1])}))
    for (family, op), v in sorted(by_op.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[split {name}]   {v:8.3f} ms  {family} | {op}")


def breakdown_and_reference(cfg, state, plan, step, batch, seed, ms_step):
    """One more step, stage by stage with a synchronise after each stage
    (host clock), then its aggregate recomputed on the CPU through the plain
    versions from the same per-user gradients and seed.  HSQ units may
    differ only on a few subvectors (near-tie codes, level boundaries);
    identity units must agree to 1e-6 of the summed magnitudes."""
    import torch

    from gqx_torch.models.common import update_running_stats
    from gqx_torch.train import fused_sgd_update

    x, y, _ = batch
    model = state.model
    times = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = times.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
        return out

    _, grads = timed("user_fwd_bwd", lambda: per_user_grads(cfg, state, plan, x, y))
    units = timed("pack", lambda: plan.pack(grads))
    sigs, means = [], []
    for u, g in zip(plan.units, units):
        comp = u.compressor
        sig = timed("encode+norm", lambda: comp.compress_batch(g, torch.Generator().manual_seed(seed)))
        means.append(timed("decode_mean", lambda: comp.decode_mean(sig)))
        sigs.append(sig)
    agg = timed("unpack", lambda: plan.unpack(means))
    timed("sgd_update+bn", lambda: (fused_sgd_update(
        agg, dict(model.named_parameters()), state.trace, 0.1, 5e-4, 0.9),
        update_running_stats(model)))
    log("[breakdown] one step, ms (host clock, synchronised per stage): "
        + json.dumps({k: round(v, 3) for k, v in times.items()}))
    device_profile(state, step, batch, ms_step)

    for u, g, gpu in zip(plan.units, units, means):
        comp = u.compressor
        cpu = comp.decode_mean(comp.compress_batch(g.cpu(), torch.Generator().manual_seed(seed)))
        gpu = gpu.cpu()
        if type(comp).__name__ == "HSQCompressor":
            err = (gpu - cpu).abs().reshape(-1, comp.dim).amax(1)
            bad = int((err > 1e-5 * cpu.abs().reshape(-1, comp.dim).amax(1)).sum())
            log(f"[reference] HSQ unit of {u.size}: {bad} of {comp.M} subvectors differ "
                f"from the CPU plain path (near-tie codes / level boundaries)")
            if bad > 1e-3 * comp.M:
                raise AssertionError(f"HSQ aggregate differs from the CPU plain path on {bad} subvectors")
        else:
            err = (gpu - cpu).abs()
            tol = 1e-6 * g.cpu().float().abs().mean(0)
            log(f"[reference] identity unit of {u.size}: max |gpu - cpu| {float(err.max()):.3e}")
            if not bool((err <= tol).all()):
                raise AssertionError("identity aggregate differs from the CPU path")


def _subvectors_off(got, want, dim: int) -> int:
    """How many dim-wide subvectors of ``got`` differ from ``want`` by more
    than 1e-5 of the subvector's largest magnitude."""
    err = (got - want).abs().reshape(-1, dim).amax(1)
    return int((err > 1e-5 * want.abs().reshape(-1, dim).amax(1)).sum())


def _samplers(plan):
    """(unit index, object, method) of each sampler of the plan's units:
    Maurey's ``sample``, PVQ's ``encode`` (Residual's second stage)."""
    out = []
    for ui, u in enumerate(plan.units):
        comp = u.compressor
        kind = type(comp).__name__
        if kind == "MaureySparsificationCompressor":
            out.append((ui, comp, "sample"))
        elif kind == "ProbabilisticVectorCompressor":
            out.append((ui, comp, "encode"))
        elif kind == "ResidualCompressor":
            out.append((ui, comp.stages[1], "encode"))
    return out


@contextlib.contextmanager
def recorded_samples(plan):
    """Record, while the block runs, each sampler's (input, uniforms,
    output) and the signature of the unit that holds it:
    ({unit index: (vecs, r, out)}, {unit index: signature})."""
    calls, sigs = {}, {}
    hooked = _samplers(plan)
    for ui, obj, method in hooked:
        def record(vecs, r, ui=ui, fn=getattr(obj, method)):
            out = fn(vecs, r)
            calls[ui] = (vecs, r, out)
            return out

        def record_sig(vecs, generator=None, ui=ui, fn=plan.units[ui].compressor.compress_batch):
            sigs[ui] = fn(vecs, generator)
            return sigs[ui]
        setattr(obj, method, record)
        plan.units[ui].compressor.compress_batch = record_sig
    try:
        yield calls, sigs
    finally:
        for ui, obj, method in hooked:
            delattr(obj, method)
            del plan.units[ui].compressor.compress_batch


def _rows_recoded(comp, card, cpu):
    """(U, M) bool: the users' subvectors whose code or norm level differs
    between the two signatures of a PVQ or Residual unit."""
    stages = [(card["stage0"], cpu["stage0"]), (card["stage1"], cpu["stage1"])] \
        if type(comp).__name__ == "ResidualCompressor" else [(card, cpu)]
    rows = None
    for a, b in stages:
        diff = a["codes"].cpu() != b["codes"]
        if isinstance(b["u"], dict):
            diff |= a["u"]["l"].cpu() != b["u"]["l"]
        rows = diff if rows is None else rows | diff
    return rows


def samples_off(name, plan, card, cpu):
    """Samples whose code on the card differs from the CPU's, from the same
    uniforms (``card``, ``cpu``: the sampler calls ``recorded_samples``
    kept): each must have r (PVQ: r - eps) within tol of the float64 CDF
    between its two codes, tol the float32 sum's error bound over K terms
    on both devices for PVQ, 1e-9 for Maurey's float64 CDF.  A PVQ sample
    whose input row differs (the Residual's HSQ stage chose another code)
    is counted apart."""
    import torch

    from gqx_torch.compress.sparse import maurey_cdf

    tally = {}
    for ui, obj, method in _samplers(plan):
        (v_g, r_g, out_g), (v_c, r_c, out_c) = card[ui], cpu[ui]
        if not torch.equal(r_g.cpu(), r_c):
            raise AssertionError(f"{name}: unit {ui}'s uniforms differ between card and CPU")
        pvq = method == "encode"
        got = (out_g[1] if pvq else out_g["codes"]).cpu().long().reshape(-1)
        want = (out_c[1] if pvq else out_c["codes"]).long().reshape(-1)
        r = r_c.double().reshape(-1)
        moved = torch.nonzero(got != want)[:, 0]
        other_input = 0
        if pvq:
            eps, tol = 1e-5, 2 * obj.K * 2.0 ** -24
            rows_c = v_c.reshape(-1, obj.dim)
            rows_g = v_g.reshape(-1, obj.dim)[moved.to(v_g.device)].cpu()
            same = (rows_g == rows_c[moved]).all(1)
            other_input = int((~same).sum())
            moved = moved[same]
            p = rows_c[moved].double() @ obj.c_dagger.double().t()
            cdf = torch.cumsum(p.abs() / p.abs().sum(1, keepdim=True), dim=1)
        else:
            eps, tol = 0.0, 1e-9
            users = sorted({int(s) // obj.k for s in moved})
            cdfs = {u: maurey_cdf(v_c.reshape(v_c.shape[0], -1)[u:u + 1])[1][0] for u in users}
        for j, s in enumerate(moved.tolist()):
            lo, hi = sorted((int(got[s]), int(want[s])))
            row = cdf[j] if pvq else cdfs[s // obj.k]
            if float((r[s] - eps - row[lo:hi]).abs().min()) > tol:
                raise AssertionError(f"{name}: unit {ui}, sample {s}: codes {int(got[s])} on the "
                                     f"card, {int(want[s])} on the CPU, r {float(r[s])} not at "
                                     "a CDF boundary")
        t = tally.setdefault("PVQ" if pvq else "Maurey", [0, 0, 0, 0])
        t[0] += len(moved)
        t[1] += got.numel()
        t[2] += other_input
        t[3] += 1
    for kind, (n, total, other, units) in tally.items():
        log(f"[samples {name}] {kind}, {units} unit(s): {n + other} of {total} samples land in "
            f"another slot than on the CPU, {n} at a CDF boundary from the same input row, "
            f"{other} from a row the HSQ stage coded otherwise")


def maurey_sample_f32(comp, vecs, r):
    """Maurey's codes and signs from gqx's float32 CDF (gqx/compress/
    sparse.py: l1, |v| / l1 and their cumulative sum all in float32), the
    arithmetic the port's float64 ``maurey_cdf`` departs from."""
    import torch

    flat = vecs.reshape(vecs.shape[0], -1)
    a = flat.abs().to(torch.float32)
    l1 = a.sum(1)
    safe = torch.where(l1 == 0.0, torch.ones_like(l1), l1)
    cdf = torch.cumsum(a / safe[:, None], dim=1)
    codes = torch.searchsorted(cdf, r).clamp(0, comp.size - 1)
    return codes, torch.sign(flat.gather(1, codes))


def maurey_precision(name, plan, card, cpu):
    """The cost of Maurey's float64 CDF against gqx's float32 one, on this
    step's Maurey units from the inputs and uniforms the samplers were given
    (``recorded_samples``): the samples that land in another slot on the card
    than on the CPU under float32, and the device time of all the units'
    samplers under each precision."""
    units = [(ui, obj) for ui, obj, method in _samplers(plan) if method == "sample"]
    if not units:
        return
    moved = total = 0
    for ui, obj in units:
        (v_g, r_g, _), (v_c, r_c, _) = card[ui], cpu[ui]
        got = maurey_sample_f32(obj, v_g, r_g)[0].cpu()
        want = maurey_sample_f32(obj, v_c, r_c)[0]
        moved += int((got != want).sum())
        total += want.numel()
    f64_ms = device_ms(lambda: [obj.sample(*card[ui][:2]) for ui, obj in units], 3)
    f32_ms = device_ms(lambda: [maurey_sample_f32(obj, *card[ui][:2]) for ui, obj in units], 3)
    log(f"[samples {name}] Maurey under gqx's float32 CDF: {moved} of {total} samples land in "
        f"another slot than on the CPU; samplers of the {len(units)} units a step: float64 "
        f"{f64_ms:.3f} ms device time, float32 {f32_ms:.3f} ms")


def sampled_unit_reference(name, unit, got, want, card_sig, cpu_sig):
    """A PVQ or Residual unit's mean on the card against the CPU's: every
    subvector that differs by more than 1e-5 of its largest magnitude must
    have a user whose code or norm level differs between the two (a sample
    at a CDF boundary; a level whose stochastic rounding met a u that
    differs by float32 roundings), or differ by no more than 1e-5 of the
    users' largest decoded magnitude there (the terms of a mean that
    cancels); codes and levels may differ in at most 1e-3 of the users'
    subvectors."""
    comp = unit.compressor
    dim = comp.stages[0].dim if type(comp).__name__ == "ResidualCompressor" else comp.dim
    recoded = _rows_recoded(comp, card_sig, cpu_sig)
    err = (got - want).abs().reshape(-1, dim).amax(1)
    off = err > 1e-5 * want.abs().reshape(-1, dim).amax(1)
    terms = comp.decompress_batch(cpu_sig).abs().reshape(recoded.shape[0], -1, dim).amax(2).amax(0)
    explained = recoded.any(0)
    unexplained = off & ~explained & (err > 1e-5 * terms)
    log(f"[reference {name}] aggregate, {type(comp).__name__} unit of {unit.size}: "
        f"{int(off.sum())} of {off.numel()} subvectors differ from the CPU plain path, "
        f"{int((off & explained).sum())} where a user's code or level differs "
        f"({int(recoded.sum())} of {recoded.numel()} users' subvectors recoded), "
        f"{int((off & ~explained).sum())} within 1e-5 of the users' terms")
    if int(unexplained.sum()) or int(recoded.sum()) > 1e-3 * recoded.numel():
        raise AssertionError(f"{name}: {int(unexplained.sum())} subvectors differ unexplained, "
                             f"{int(recoded.sum())} users' subvectors recoded")


def aggregate_reference(name, cfg, state, plan, step, batch, seed, ms_step):
    """One more step's gradients aggregated on the card, stage-timed (host
    clock, synchronised per stage), and, from the same gradients, the same
    aggregator state and the same seed, on the CPU, where every wrapper
    computes its plain version.  HSQ units (aggregate and new error-feedback
    state) may differ only on a few subvectors (near-tie codes, level
    boundaries: at most 1e-3 of them); PVQ and Residual units as
    ``sampled_unit_reference`` says; QSGD, sign and Maurey units only on a
    few elements (at most 1e-5 of them: the same exactly rounded
    operations on both devices, but for the order of the users' sum);
    top-k and identity units must agree exactly and to 1e-6 of the summed
    magnitudes.  The samplers' codes are held to ``samples_off``."""
    import torch

    from gqx_torch.parallel.aggregate import AggState, make_aggregator
    from gqx_torch.parallel.packing import UnitPlan

    x, y, _ = batch
    times = {}
    # the same units without the bf16 cast of pack(), to compare in float32
    f32_plan = UnitPlan(plan.names, plan.leaf_shapes, plan.units, layout=plan.layout)

    def timed(label, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[label] = round((time.perf_counter() - t0) * 1e3, 3)
        return out

    def to_cpu(group):
        return None if group is None else [t.cpu().clone() for t in group]

    aggregator = make_aggregator(cfg, plan)
    scale = cfg.ef_scale(EF_EPOCH)
    _, grads = timed("user_fwd_bwd", lambda: per_user_grads(cfg, state, plan, x, y))
    cpu_state = AggState(to_cpu(state.agg_state.ef), to_cpu(state.agg_state.server_ef))
    cpu_grads = {n: g.cpu() for n, g in grads.items()}
    with recorded_samples(plan) as (card, card_sigs):
        agg = timed("aggregate", lambda: aggregator(
            grads, state.agg_state, scale, torch.Generator().manual_seed(seed)))
    log(f"[breakdown {name}] ms (host clock, synchronised per stage): {json.dumps(times)}")
    with recorded_samples(plan) as (cpu, cpu_sigs):
        want = aggregator(cpu_grads, cpu_state, scale, torch.Generator().manual_seed(seed))
    samples_off(name, plan, card, cpu)
    maurey_precision(name, plan, card, cpu)
    del card, cpu

    groups = [("aggregate", f32_plan.pack(agg), f32_plan.pack(want))]
    if state.agg_state.ef is not None:
        groups.append(("error feedback", state.agg_state.ef, cpu_state.ef))
    if state.agg_state.server_ef is not None:
        groups.append(("server error feedback", state.agg_state.server_ef, cpu_state.server_ef))
    for label, got_units, want_units in groups:
        tally = {}
        for ui, (u, got, ref, g) in enumerate(zip(plan.units, got_units, want_units,
                                                  f32_plan.pack(cpu_grads))):
            comp = u.compressor
            kind = type(comp).__name__
            got, ref = got.cpu().float(), ref.float()
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{name} {label}: non-finite values")
            if ui in cpu_sigs and label == "aggregate" and kind in SUBVECTOR_UNITS:
                sampled_unit_reference(name, u, got, ref, card_sigs[ui], cpu_sigs[ui])
                continue
            if kind in SUBVECTOR_UNITS:
                dim = comp.stages[0].dim if kind == "ResidualCompressor" else comp.dim
                bad, total = _subvectors_off(got, ref, dim), got.numel() // dim
                limit, what = 1e-3 * total, "subvectors"
            elif kind in ("TopKCompressor", "IdenticalCompressor"):
                tol = 0.0 if kind == "TopKCompressor" else 1e-6 * g.float().abs().sum(0) + 1e-30
                bad, total = int(((got - ref).abs() > tol).sum()), got.numel()
                limit, what = 0, "elements"
            else:
                bad, total = int(((got - ref).abs() > 1e-6 * ref.abs().max()).sum()), got.numel()
                limit, what = 1e-5 * total, "elements"
            if bad > limit:
                raise AssertionError(f"{name} {label}: {kind} unit of {u.size}: {bad} of "
                                     f"{total} {what} differ from the CPU plain path")
            t = tally.setdefault((kind, what), [0, 0, 0, 0])
            t[0] += bad
            t[1] += total
            t[2] += 1
            t[3] += u.size
        for (kind, what), (bad, total, units, size) in tally.items():
            log(f"[reference {name}] {label}, {units} {kind} unit(s) of {size} elements: "
                f"{bad} of {total} {what} differ from the CPU plain path")
    device_profile(state, step, batch, ms_step)


def eval_check(state, batch):
    """One eval step on the first user's micro-batch: a finite loss, a
    count of correct predictions, and the model left in training mode."""
    import math

    from gqx_torch.train import evaluate, make_eval_step

    x, y, _ = batch
    loss, acc = evaluate(make_eval_step(state.model), [(x[i], y[i]) for i in range(2)])
    if not (math.isfinite(loss) and 0.0 <= acc <= 1.0 and state.model.training):
        raise AssertionError(f"eval: loss {loss}, accuracy {acc}, training {state.model.training}")
    log(f"[eval] 2 batches of {x.shape[1]}: loss {loss:.5f} (the reference's sum of batch means "
        f"over the dataset size), accuracy {acc:.4f}")


# folded against looped per-user gradients; see folded_vs_looped
GRAD_TOL = {
    # float32: per leaf, the median |diff| and the L2 error, relative to the
    # leaf's largest magnitude and to its norm
    "float32": dict(median=1e-5, leaf_l2=2e-2),
    # bf16: the L2 error of all leaves together (per network) and of the
    # worst conv or dense weight, each relative to its norm, and as a
    # multiple of the same error of the bf16 loop against the float32 loop.
    # VGG-16's bf16 gradients lie 0.14 from its float32 ones (the loop
    # against the loop, NVIDIA H100): without a shortcut, every one of its 13
    # BN layers and 5 max pools passes a bf16 rounding on, and a one-ulp
    # change moves a pooled window's maximum; its bound is twice that
    "bfloat16": dict(all_l2={"resnet50": 2e-2, "vgg16": 0.3, "dense": 2e-2}, weight_l2=0.4,
                     of_bf16_noise=2.0),
}


def _grad_errors(model, names, got, want):
    """(relative L2 error over all leaves together, worst relative L2 error
    of a conv or dense weight with its name, per leaf rows (relative L2,
    max and median |diff| over the leaf's largest magnitude, name))."""
    import torch

    rows, num, den, worst_w = [], 0.0, 0.0, (0.0, "")
    for n in names:
        g, w = got[n], want[n]
        owner = type(model.get_submodule(n.rsplit(".", 1)[0])).__name__
        if owner in ("Conv2d", "Dense") and n.endswith("bias"):   # no ghost: the folded total / U
            g = g.mean(0, keepdim=True).expand_as(g)
            w = w.mean(0, keepdim=True).expand_as(w)
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"gradient of {n} is not finite")
        diff = (g - w).abs()
        scale = float(w.abs().max().clamp_min(1e-30))
        l2 = float(diff.norm() / w.norm().clamp_min(1e-30))
        num, den = num + float(diff.norm()) ** 2, den + float(w.norm()) ** 2
        rows.append((l2, float(diff.max()) / scale, float(diff.median()) / scale, n))
        if model.get_parameter(n).dim() >= 2 and l2 > worst_w[0]:
            worst_w = (l2, n)
    return (num / den) ** 0.5, worst_w, rows


def folded_vs_looped(seed: int):
    """From the same weights and batch on the card, the folded step's
    per-user gradients against the per-user loop's, at 8 users x 32.  BN
    biases are drawn from [1, 2], which keeps most ReLU inputs away from 0.
    Returns the per_user_dw launches of each folded run, counted from 0 just
    before it, which must be ``dw_per_step``'s: ResNet-18 float32 takes the
    float32 tensor-core kernel for 13 of its 14 stride-1 3x3 convs and the
    narrow float32 kernel for the stem, ResNet-50 bf16 the 13 + 1 of a
    folded step, VGG-16 bf16 12 + 1 and DenseNet-BC bf16 58 + 1.  VGG-16 and
    DenseNet-BC are where max pooling, the conv bias and the channel
    concatenation first run on the card.

    ResNet-18 in float32 (no TF32): the two routes differ by the summation
    order of cuDNN's algorithms for batch 256 and batch 32, about 1e-6, but
    among 10^7 ReLU inputs a few lie that close to zero and take opposite
    signs; one such flip moves a few elements by percents of the leaf's
    scale (a BN bias gradient sums only B*H*W = 512 terms at the last stage)
    and everything upstream of it a little.  So each leaf is held by its
    median |diff| over its largest magnitude and by its relative L2 error.

    ResNet-50, VGG-16 and DenseNet-BC in bf16 compute: activations differ
    in the last bf16 bit
    between the routes and each leaf is itself rounded to bf16.  The gradient
    of a BN bias that feeds the next block's BN is, by that BN's shift
    invariance, a sum that nearly cancels, so its relative error says
    nothing (as does that of a conv bias a BN follows, VGG-16's: zero in
    exact arithmetic); the check is on all leaves together and on the worst
    conv or dense weight, in relative L2, absolutely (GRAD_TOL, per network)
    and against the yardstick of
    bf16 itself: the same loop in bf16 against the loop in float32.  The
    folded gradients must also lie as close to the float32 loop as the bf16
    loop does (within 1.5x)."""
    import numpy as np
    import torch

    from gqx_torch.models import create_model
    from gqx_torch.models.common import clear_batch_stats
    from gqx_torch.train import create_train_state, folded_user_grads, user_grads

    dev = torch.device("cuda")
    launches = {}

    def build(network, dtype):
        cfg = canonical_config(network=network, compute_dtype=dtype)
        gen = torch.Generator().manual_seed(seed + 5)
        model = create_model(network, cfg.num_classes, dtype, gen)
        with torch.no_grad():
            for mod in model.modules():
                if type(mod).__name__ == "BatchNorm":
                    mod.bias.uniform_(1.0, 2.0, generator=gen)
        state, plan = create_train_state(cfg, model, device="cuda")
        return cfg, model, plan

    for network, dtype in (("resnet18", "float32"), ("resnet50", "bfloat16"),
                           ("vgg16", "bfloat16"), ("dense", "bfloat16")):
        cfg, model, plan = build(network, dtype)
        rng = np.random.default_rng(seed + 5)
        h, w, c = model.image_shape
        x = torch.from_numpy(rng.standard_normal(
            (cfg.num_users, cfg.batch_size, c, h, w), dtype=np.float32)).to(dev)
        y = torch.from_numpy(rng.integers(0, 10, (cfg.num_users, cfg.batch_size))).to(dev)
        counters(reset=True)
        loss_f, grads_f = folded_user_grads(model, plan, plan.names, x, y)
        got = {k: v for k, v in counters().items() if k.startswith("per_user_dw")}
        want = dw_per_step(network, dtype)
        if got != want:
            raise AssertionError(f"folded {network} {dtype}: per_user_dw launches {got}, "
                                 f"expected {want}")
        launches[f"{network} {dtype} folded"] = got
        clear_batch_stats(model)
        loss_l, grads_l = user_grads(model, plan.names, x, y)
        clear_batch_stats(model)
        torch.cuda.synchronize()
        all_l2, (weight_l2, weight_name), rows = _grad_errors(model, plan.names, grads_f, grads_l)
        d_loss = float((loss_f - loss_l).abs().max())
        log(f"[folded vs loop] {network} {dtype} 8x32, {len(rows)} leaves: relative L2 of all "
            f"leaves together {all_l2:.3e}, worst weight {weight_l2:.3e} ({weight_name}), worst "
            f"leaf {max(r[0] for r in rows):.3e}; median |diff| / scale up to "
            f"{max(r[2] for r in rows):.3e}; losses differ by up to {d_loss:.3e}")
        for r in sorted(rows, reverse=True)[:3]:
            log(f"[folded vs loop]   {r[3]}: relative L2 {r[0]:.3e}, max {r[1]:.3e}, "
                f"median {r[2]:.3e} of the leaf's scale")
        tol = GRAD_TOL[dtype]
        if dtype == "float32":
            ok = (max(r[2] for r in rows) <= tol["median"]
                  and max(r[0] for r in rows) <= tol["leaf_l2"] and d_loss <= 1e-5)
        else:
            _, model32, plan32 = build(network, "float32")
            _, grads_32 = user_grads(model32, plan32.names, x, y)
            torch.cuda.synchronize()
            noise_all, (noise_w, noise_name), _ = _grad_errors(model, plan.names, grads_l, grads_32)
            log(f"[folded vs loop]   the yardstick, bf16 loop against float32 loop: all leaves "
                f"together {noise_all:.3e}, worst weight {noise_w:.3e} ({noise_name})")
            truth_all, (truth_w, truth_name), _ = _grad_errors(model, plan.names, grads_f, grads_32)
            log(f"[folded vs loop]   bf16 folded against float32 loop: all leaves together "
                f"{truth_all:.3e}, worst weight {truth_w:.3e} ({truth_name})")
            ok = (all_l2 <= tol["all_l2"][network] and weight_l2 <= tol["weight_l2"]
                  and all_l2 <= tol["of_bf16_noise"] * noise_all
                  and weight_l2 <= tol["of_bf16_noise"] * noise_w
                  and truth_all <= 1.5 * noise_all and truth_w <= 1.5 * noise_w
                  and d_loss <= 5e-2)
            del grads_32, model32
        if not ok:
            raise AssertionError(f"folded and looped gradients of {network} {dtype} differ "
                                 f"beyond {tol}")
        del grads_f, grads_l, model
        torch.cuda.empty_cache()
    return launches


def comparison_phase(seed: int, steps: int, entries):
    """1 + ``steps`` folded steps of each configuration of COMPARISON, the
    launch counters set to 0 just before the ``steps`` and read just after;
    the aggregates but sgd's and terngrad's against the CPU plain path (those
    two: one step's device time)."""
    import torch

    for name, (extra, per_unit) in COMPARISON.items():
        cfg = canonical_config(**extra)
        ms, losses, state, plan, step, batch, launches = run_steps(cfg, seed, steps, counters)
        log(f"[slice {name}] resnet50 8x32 {extra} bf16, folded: {ms:.2f} ms/step over "
            f"{steps} steps, losses {[round(v, 4) for v in losses]}, "
            f"wire {plan.wire_bytes()} B/user/step, {len(plan.units)} units")
        log(f"[slice {name}] launches: { {k: v for k, v in launches.items() if v} }")
        check_launches(name, cfg, plan, steps, launches, per_unit, entries)
        if name not in ("sgd", "terngrad"):
            aggregate_reference(name, cfg, state, plan, step, batch, seed, ms)
        else:
            device_profile(state, step, batch, ms)
        del state, step, batch
        torch.cuda.empty_cache()


# the [wire] phase: the configuration of each of the eight compressors whose
# largest ResNet-50 unit is packed (sgd's: its largest leaf)
WIRE = {
    "sgd": COMPARISON["sgd"][0],
    "sign": COMPARISON["sign"][0],
    "qsgd2bit": COMPARISON["qsgd2bit"][0],
    "hsq P1": dict(),
    "pvq": COMPARISON["pvq"][0],
    "residual P9": PATHS["P9"][0],
    "topk": COMPARISON["topk"][0],
    "maurey": COMPARISON["maurey"][0],
}


def _user(sig, i):
    if isinstance(sig, dict):
        return {k: _user(v, i) for k, v in sig.items()}
    return sig[i]


def _to_cpu(sig):
    if isinstance(sig, dict):
        return {k: _to_cpu(v) for k, v in sig.items()}
    return sig.cpu()


def _bit_equal(got, want) -> bool:
    import torch

    if isinstance(want, dict):
        return set(got) == set(want) and all(_bit_equal(got[k], want[k]) for k in want)
    got, want = got.cpu(), want.cpu()
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    if got.is_floating_point():
        got, want = got.view(torch.int32), want.view(torch.int32)
    return torch.equal(got, want)


def wire_phase(seed: int):
    """[wire]: for each configuration of WIRE, 8 users' signatures of the
    plan's largest unit, compressed on the card from gradient-like input;
    each user's signature packed on the card must give the CPU's words for
    the same signature, unpack on the card to it bit for bit, and fill
    exactly ``wire_bytes``.  Pack and unpack of one user's signature are
    timed on the device (torch.profiler) and by CUDA events."""
    import torch

    from gqx_torch.ops.wire import pack_signature, unpack_signature, wire_bytes

    for name, extra in WIRE.items():
        cfg = canonical_config(**extra)
        plan = resnet50_plan(cfg, seed)
        ui = max(range(len(plan.units)), key=lambda i: plan.units[i].size)
        unit, dtype = plan.units[ui], plan.unit_dtypes[ui]
        comp = unit.compressor
        x = unit_input(unit, cfg.num_users, seed + 9)
        sig = comp.compress_batch(x if dtype is None else x.to(dtype),
                                  torch.Generator().manual_seed(seed))
        want_bytes = wire_bytes(comp)
        for i in range(cfg.num_users):
            one = _user(sig, i)
            wire = pack_signature(comp, one)
            cpu = pack_signature(comp, _to_cpu(one))
            if set(wire) != set(cpu) or not all(torch.equal(wire[k].cpu(), cpu[k]) for k in cpu):
                raise AssertionError(f"wire {name}: user {i}'s words on the card differ from "
                                     "the CPU's")
            if sum(4 * w.numel() for w in wire.values()) != want_bytes:
                raise AssertionError(f"wire {name}: the payload is not wire_bytes "
                                     f"{want_bytes}")
            if not _bit_equal(unpack_signature(comp, wire), one):
                raise AssertionError(f"wire {name}: user {i}'s unpack differs from the "
                                     "signature")
        one = _user(sig, 0)
        wire = pack_signature(comp, one)
        # the identity's payload is a view of the float32 bits: no kernel
        views = type(comp).__name__ == "IdenticalCompressor"
        times = [0.0 if views else device_ms(lambda: pack_signature(comp, one), 5),
                 cuda_ms(lambda: pack_signature(comp, one), 5),
                 0.0 if views else device_ms(lambda: unpack_signature(comp, wire), 5),
                 cuda_ms(lambda: unpack_signature(comp, wire), 5)]
        log(f"[wire] {name}: {type(comp).__name__} unit of {unit.size} elements, "
            f"{want_bytes} B per user ({4 * unit.size / want_bytes:.2f}x fp32), "
            f"{len(wire)} fields; {cfg.num_users} users packed on the card bit-equal to the "
            f"CPU, unpacked bit-exact; per user and step: pack {times[0]:.4f} ms device, "
            f"{times[1]:.4f} ms events; unpack {times[2]:.4f} ms device, {times[3]:.4f} ms "
            "events")
        del sig, x
        torch.cuda.empty_cache()


# the [cli] drive: gqx's canonical HSQ command line (ResNet-50, 8 users x 32)
# at gqx's default float32 compute, 16 steps on the synthetic set's 4,096
# images, then two epochs with --resume; launches per step of each kernel
# (the conv weight gradient's: dw_per_step)
CLI_FLAGS = ["--network", "resnet50", "--dataset", "synthetic", "--quantizer", "hsq",
             "--c-dim", "16", "--k-bit", "8", "--n-bit", "6", "--num-users", "8",
             "--batch-size", "32", "--save-model"]
CLI_STEPS_PER_EPOCH = 16
HSQ_PER_STEP = {"hsq_encode": 1, "philox_uniform": 1, "hsq_decode_mean": 1}
# VGG-16 through the CLI, float32 (gqx's default: K7's float32 routes), one
# epoch of the synthetic set and its eval
VGG_FLAGS = ["--network", "vgg16", "--dataset", "synthetic", "--quantizer", "hsq",
             "--c-dim", "16", "--k-bit", "8", "--n-bit", "6", "--num-users", "8",
             "--batch-size", "32", "--epochs", "1"]
# the LeNet CNN on MNIST-format files made from the seed (2,048 training
# images of 28x28x1: 8 steps at 8 x 32): its 5x5 VALID convs take no K7, and
# its compressed weights (25,000, 400,000, 5,000) make one flat HSQ unit at
# c_dim 8 (at c_dim 16 gqx's subvector rule finds no dim for 25,000)
CNN_FLAGS = ["--network", "cnn", "--dataset", "mnist", "--quantizer", "hsq",
             "--c-dim", "8", "--k-bit", "8", "--n-bit", "6", "--num-users", "8",
             "--batch-size", "32", "--epochs", "1"]
CNN_TRAIN, CNN_TEST = 2048, 1024
# the verify drive: FCN on the synthetic set, 32 steps; gqx ends at 100%
FCN_FLAGS = ["--network", "fcn", "--dataset", "synthetic", "--quantizer", "hsq",
             "--c-dim", "16", "--k-bit", "6", "--n-bit", "6", "--num-users", "8",
             "--batch-size", "16", "--epochs", "1"]
FCN_MIN_ACCURACY = 0.99


def _drive(main, argv, label):
    """Call an entry point's ``main(argv)`` in process with its standard
    output shown prefixed and kept; returns (result, output)."""
    import contextlib
    import io

    kept = io.StringIO()
    with contextlib.redirect_stdout(kept):
        result = main(argv)
    text = kept.getvalue()
    for line in text.splitlines():
        log(f"[{label}] {line}")
    return result, text


def write_mnist(data_dir: str, seed: int, n_train: int, n_test: int):
    """MNIST's idx files (28x28 uint8 images, uint8 labels) of class
    templates plus noise, made from ``seed``, as ``--dataset mnist`` reads
    them."""
    import os

    import numpy as np

    rng = np.random.default_rng(seed)
    templates = rng.integers(0, 256, size=(10, 28, 28))
    for prefix, n in (("train", n_train), ("t10k", n_test)):
        y = rng.integers(0, 10, size=n)
        x = np.clip(templates[y] * 0.5 + 64 + rng.normal(0, 32, size=(n, 28, 28)), 0, 255)
        with open(os.path.join(data_dir, f"{prefix}-images-idx3-ubyte"), "wb") as f:
            f.write(np.array([0x803, n, 28, 28], ">u4").tobytes() + x.astype(np.uint8).tobytes())
        with open(os.path.join(data_dir, f"{prefix}-labels-idx1-ubyte"), "wb") as f:
            f.write(np.array([0x801, n], ">u4").tobytes() + y.astype(np.uint8).tobytes())


def cli_run(argv, label, steps, per_step, entries):
    """One ``gqx_torch.cli.main`` run with the launch counters set to 0
    before and read after: ``steps`` steps taken, each kernel launched
    ``per_step`` times a step (0 where it is not named), finite scalars.
    Returns (state, accuracy, output)."""
    import csv
    import math
    import os

    from gqx_torch import cli

    counters(reset=True)
    (state, accuracy), text = _drive(cli.main, argv, label)
    launches = counters()
    for kernel, count in launches.items():
        want = steps * per_step.get(kernel, 0)
        if count != want:
            raise AssertionError(f"{label}: {kernel} launched {count} times in {steps} steps, "
                                 f"expected {want}")
        if count:
            entries[kernel]["launches"] += count
            by_path = entries[kernel]["launches_by_path"]
            by_path[label] = by_path.get(label, 0) + count
    logdir = argv[argv.index("--logdir") + 1]
    with open(os.path.join(logdir, "scalars.csv")) as f:
        for r in csv.DictReader(f):
            if not math.isfinite(float(r["value"])):
                raise AssertionError(f"{label}: non-finite {r['tag']} at step {r['step']}")
    log(f"[{label}] step {state.step}, test accuracy {100 * accuracy:.2f}%, launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    return state, accuracy, text


def cli_phase(entries, seed: int):
    """``gqx_torch.cli.main`` in process: the canonical HSQ command line for
    one epoch, then for two with --resume on the same logdir; scalars.csv
    at gqx's tags and global steps; VGG-16 in float32 for one epoch; the
    CNN for one epoch of MNIST-format files made from the seed; then the
    verify skill's FCN drive.  The launch counters are set to 0 before each
    run and read after.  Returns the runner's host ms per step of the
    ResNet-50 runs (training loop, evals excluded)."""
    import csv
    import os
    import re
    import shutil
    import tempfile

    logdir = tempfile.mkdtemp(prefix="gqx_torch_cli_")
    loop_ms = []
    try:
        per_step = {**dw_per_step("resnet50", "float32"), **HSQ_PER_STEP}
        for epochs, resume in ((1, False), (2, True)):
            argv = CLI_FLAGS + ["--epochs", str(epochs), "--logdir", logdir]
            state, accuracy, text = cli_run(argv + (["--resume"] if resume else []), "cli",
                                            CLI_STEPS_PER_EPOCH, per_step, entries)
            if state.step != CLI_STEPS_PER_EPOCH * epochs:
                raise AssertionError(f"cli: the run ended at step {state.step}, expected "
                                     f"{CLI_STEPS_PER_EPOCH * epochs}")
            loop_ms.append(float(re.search(r"training loop ([\d.]+) ms/step", text).group(1)))
        with open(os.path.join(logdir, "scalars.csv")) as f:
            rows = list(csv.DictReader(f))
        got = {}
        for r in rows:
            got.setdefault(r["tag"], []).append(int(r["step"]))
        last = CLI_STEPS_PER_EPOCH - 1
        want = {"wire_bytes_per_user_step": [0, 0], "compression_ratio_vs_fp32": [0, 0],
                "loss": [last, CLI_STEPS_PER_EPOCH + last],
                "accuracy(%)": [last, CLI_STEPS_PER_EPOCH + last]}
        if got != want:
            raise AssertionError(f"cli: scalars.csv holds {got}, expected {want}")
        ckpts = sorted(f for f in os.listdir(logdir) if f.startswith("gqx_state_"))
        log(f"[cli] scalars.csv {got}; checkpoints {ckpts}")

        state, _, _ = cli_run(VGG_FLAGS + ["--logdir", os.path.join(logdir, "vgg16")],
                              "cli vgg16", CLI_STEPS_PER_EPOCH,
                              {**dw_per_step("vgg16", "float32"), **HSQ_PER_STEP}, entries)
        if state.step != CLI_STEPS_PER_EPOCH:
            raise AssertionError(f"cli vgg16: the run ended at step {state.step}")

        mnist_dir = os.path.join(logdir, "mnist")
        os.makedirs(mnist_dir)
        write_mnist(mnist_dir, seed, CNN_TRAIN, CNN_TEST)
        steps = CNN_TRAIN // (8 * 32)
        state, _, _ = cli_run(CNN_FLAGS + ["--data-dir", mnist_dir, "--logdir",
                                           os.path.join(logdir, "cnn")],
                              "cli cnn", steps, HSQ_PER_STEP, entries)
        if state.step != steps:
            raise AssertionError(f"cli cnn: the run ended at step {state.step}, expected {steps}")

        _, accuracy, _ = cli_run(FCN_FLAGS + ["--logdir", os.path.join(logdir, "fcn")],
                                 "cli fcn", 32, HSQ_PER_STEP, entries)
        if not accuracy >= FCN_MIN_ACCURACY:
            raise AssertionError(f"cli fcn: test accuracy {accuracy}, expected >= "
                                 f"{FCN_MIN_ACCURACY}")
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    return loop_ms


def bench_phase(entries, runner_ms):
    """``gqx_torch.bench.main`` in process for hsq and sgd (bf16, 1 + 1 + 5
    steps) and for hsq in float32, the [cli] drive's configuration: the
    families of each device-time split, without what it could not
    attribute, must sum to its device total within 1%; the float32 hsq
    ms per step is printed beside the runner's."""
    from gqx_torch import bench

    counters(reset=True)
    details, _ = _drive(bench.main, ["--quant", "hsq,sgd", "--warmup", "1", "--steps", "5"],
                        "bench")
    launches = counters()
    for kernel in ("hsq_encode", "philox_uniform", "hsq_decode_mean", "per_user_dw_tc",
                   "per_user_dw_narrow"):
        if launches[kernel] < 1:
            raise AssertionError(f"bench: {kernel} was not launched")
    for kernel, count in launches.items():
        if count:
            entries[kernel]["launches"] += count
            entries[kernel]["launches_by_path"]["bench"] = count
    f32, _ = _drive(bench.main, ["--quant", "hsq", "--dtype", "float32", "--warmup", "1",
                                 "--steps", "5"], "bench float32")
    for q, row in list(details["configs"].items()) + [("hsq float32", f32["configs"]["hsq"])]:
        total, split = row["device_ms_per_step"], row["device_split_ms"]
        attributed = sum(v for k, v in split.items() if k != bench.UNATTRIBUTED)
        if abs(attributed - total) > 0.01 * total:
            raise AssertionError(f"bench {q}: the families {split} sum to {attributed} ms, "
                                 f"the device total is {total} ms")
    bench_ms = f32["configs"]["hsq"]["ms_per_step"]
    log(f"[bench] resnet50 8x32 hsq float32: runner {runner_ms} ms/step (training loop, "
        f"synthetic data through the Pipeline) against bench {bench_ms:.2f} ms/step (one "
        f"batch resident on the card)")


# [kmeans]: the codebook that P12's stem needs (576 = the stem's 1,728
# weights at c_dim 256, which the repository does not ship), at gqx's
# defaults; the card's Lloyd against the CPU's at a size the CPU runs in
# seconds; a quality check against a shipped codebook gqx's k-means wrote
KMEANS_DIM, KMEANS_K = 576, 256
KMEANS_CHECK = (65_536, 5)          # rows, iterations
QUALITY = (16, 256, 200_000, 5e-3)  # dim, K, fresh samples, relative tolerance


def use_codebook_cache(directory: str) -> None:
    """Point the port's codebook cache at ``directory`` (empty, so that the
    next codebook the repository does not ship is trained) and clear the
    registry's memo."""
    import os

    from gqx_torch import codebooks

    os.makedirs(directory, exist_ok=True)
    codebooks.CACHE_DIR = directory
    codebooks.get_codebook.cache_clear()


def lloyd_lockstep(x, c, iters: int):
    """``iters`` Lloyd iterations on the card and on the CPU, each from the
    CPU's centroids.  An assignment may differ only on a near-tie (the top
    two logits within 1e-5); a centroid that no differing row touched must
    agree within 1e-5, any other within 2 / its count per moved row (a
    moved unit row shifts a mean of unit rows by at most that).  Returns
    (assignments differing per iteration, the largest margin of a
    differing one, the largest centroid difference per iteration)."""
    import torch

    from gqx_torch.codebooks import kmeans

    xd = x.cuda()
    differing, margin, errs = [], 0.0, []
    for _ in range(iters):
        a_cpu, a_card = kmeans.assign(x, c), kmeans.assign(xd, c.cuda()).cpu()
        differ = a_card != a_cpu
        differing.append(int(differ.sum()))
        if differing[-1]:
            logits = x[differ] @ c.T - 0.5 * (c * c).sum(1)
            rows = torch.arange(logits.shape[0])
            gap = logits[rows, a_cpu[differ]] - logits[rows, a_card[differ]]
            margin = max(margin, float(gap.abs().max()))
            if margin > 1e-5:
                raise AssertionError(f"k-means: an assignment differs by a logit margin of "
                                     f"{margin}")
        want = kmeans.lloyd_from(x, c, 1)
        got = kmeans.lloyd_from(xd, c.cuda(), 1).cpu()
        moved = torch.bincount(torch.cat([a_cpu[differ], a_card[differ]]), minlength=c.shape[0])
        count = torch.minimum(torch.bincount(a_cpu, minlength=c.shape[0]),
                              torch.bincount(a_card, minlength=c.shape[0])).clamp_min(1)
        err = (got - want).abs().amax(1)
        if not bool((err <= 1e-5 + 2.0 * moved / count).all()):
            raise AssertionError(f"k-means: centroids differ by up to {float(err.max())} with "
                                 f"{differing[-1]} assignments moved")
        errs.append(float(err.max()))
        c = want
    return differing, margin, errs


def kmeans_phase(seed: int, card: str):
    """Train the (576, 256) codebook at gqx's defaults (1M samples, 20
    iterations, seed 808) on the card through ``get_codebook`` into the
    (empty) cache; hold the card's Lloyd against the CPU's on the same
    samples; train a (16, 256) codebook on the card and score it against
    the shipped one over fresh unit samples.  Returns the wall ms of the
    (576, 256) training."""
    import os

    import numpy as np
    import torch

    from gqx_torch import codebooks
    from gqx_torch.codebooks import kmeans

    path = os.path.join(codebooks.CACHE_DIR, codebooks.codebook_filename(KMEANS_DIM, KMEANS_K))
    if any(os.path.exists(os.path.join(d, codebooks.codebook_filename(KMEANS_DIM, KMEANS_K)))
           for d in codebooks.search_dirs()):
        raise AssertionError("kmeans: a (576, 256) codebook exists already; nothing would train")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cb = codebooks.get_codebook(KMEANS_DIM, KMEANS_K, device="cuda")
    train_ms = (time.perf_counter() - t0) * 1e3
    if cb.shape != (KMEANS_K, KMEANS_DIM) or not np.isfinite(cb).all() or not os.path.exists(path):
        raise AssertionError(f"kmeans: codebook {cb.shape}, cached {os.path.exists(path)}")
    log(f"[kmeans] ({KMEANS_DIM}, {KMEANS_K}) trained on the card at gqx's defaults "
        f"({kmeans.DEFAULT_TRAIN_SIZE} samples, {kmeans.DEFAULT_ITERS} iterations, seed 808): "
        f"{train_ms:.1f} ms wall, peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB "
        f"allocated; cached as {path} | {card}")

    n, iters = KMEANS_CHECK
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = kmeans.unit_gaussian_samples(n, KMEANS_DIM, gen, "cuda").cpu()
    c = x[torch.randperm(n, generator=torch.Generator().manual_seed(seed))[:KMEANS_K]]
    t0 = time.perf_counter()
    differing, margin, errs = lloyd_lockstep(x, c, iters)
    log(f"[kmeans] card against CPU, {n} x {KMEANS_DIM}, K {KMEANS_K}, {iters} iterations from "
        f"the same samples and initial rows (each from the CPU's centroids): assignments "
        f"differing {differing} (first iteration {differing[0]}), largest margin of a differing "
        f"one {margin:.3e}; largest centroid difference {max(errs):.3e} (per iteration "
        f"{[f'{e:.2e}' for e in errs]}); {time.perf_counter() - t0:.1f} s | {card}")

    dim, k, m, tol = QUALITY
    t0 = time.perf_counter()
    trained = codebooks.normalize_rows(kmeans.train_codebook(dim, k, device="cuda"))[1]
    quality_ms = (time.perf_counter() - t0) * 1e3
    shipped = codebooks.fvecs_read(os.path.join(codebooks.DEFAULT_DIR,
                                                codebooks.codebook_filename(dim, k)))
    shipped = codebooks.normalize_rows(shipped)[1]
    samples = kmeans.unit_gaussian_samples(m, dim, torch.Generator(device="cuda").manual_seed(
        seed + 1), "cuda")

    def score(book):
        with torch.no_grad():
            return float((samples @ torch.from_numpy(book).cuda().T).amax(1).double().mean())

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ours, theirs = score(trained), score(shipped)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    log(f"[kmeans] quality ({dim}, {k}) trained on the card ({quality_ms:.1f} ms wall): mean best "
        f"cosine over {m} fresh unit samples {ours:.6f}, the shipped codebook's {theirs:.6f} "
        f"({100 * (ours / theirs - 1):+.3f}%) | {card}")
    if abs(ours / theirs - 1) > tol:
        raise AssertionError(f"kmeans: quality {ours} against the shipped {theirs}")
    return train_ms


def stem_rows_check(state, plan, cfg, batch, entries):
    """K6 encode (wide route) and K6 decode at P12's stem unit, 8 users x
    3 rows of 576 with the trained codebook, on the step's own bf16
    gradient rows: against their plain versions, and timed; the records
    join the ``shapes`` of both entries."""
    import torch

    from gqx_torch.ops import hsq_rows

    x, y, _ = batch
    (ui, unit), = [(i, u) for i, u in enumerate(plan.units)
                   if getattr(u.compressor, "dim", None) == KMEANS_DIM]
    comp = unit.compressor
    _, grads = per_user_grads(cfg, state, plan, x, y)
    g = plan.pack(grads)[ui]
    rows = g.reshape(cfg.num_users, comp.M, comp.dim).contiguous()
    cb = comp.codebook(rows.device)
    label = f"P12 stem {str(rows.dtype)[6:]}"
    u, codes, err = check_rows_encode(rows, cb, comp.code_dtype,
                                      f"hsq_rows_encode {label} dim {comp.dim} K {comp.K}",
                                      hsq_rows.TENSOR_CORE_WIDE)
    rec = rows_timing(label, rows, cb, comp.code_dtype)
    rec["max_abs_err"] = err
    entries["hsq_rows_encode_wide"]["shapes"].append(rec)
    d_k, d_p = hsq_rows.hsq_decode(codes, u, cb), hsq_rows.hsq_decode_plain(codes, u, cb)
    torch.cuda.synchronize()
    if not torch.equal(d_k, d_p):
        raise AssertionError(f"hsq_rows_decode {label}: not bit-equal to plain")
    # the decode reads each distinct code's codebook row once
    n, distinct = codes.numel(), int(codes.unique().numel())
    b, by = bound(n * 5 + n * comp.dim * 4 + distinct * comp.dim * 4, 1.0 * n * comp.dim,
                  FP32_FLOPS)
    dec = dict(shape=label, rows=n, distinct_codes=distinct, ms=device_ms(lambda: hsq_rows.hsq_decode(codes, u, cb), 20),
               plain_ms=device_ms(lambda: hsq_rows.hsq_decode_plain(codes, u, cb), 5),
               bound_ms=b, bound_by=by, max_abs_err=0.0)
    entries["hsq_rows_decode"].setdefault("shapes", []).append(dec)
    log(f"[hsq_rows_decode {label}] {n} rows of {comp.dim}, {distinct} distinct codes: "
        f"bit-equal to plain; {dec['ms']:.4f} ms device time (bound {b:.4f} ms by {by}), plain "
        f"{dec['plain_ms']:.4f} ms")


# [cli c256]: gqx's CLI at c_dim 256 and the default passthrough threshold on
# ResNet-50 (gqx's default float32 compute), one epoch of the synthetic set;
# the stem's (576, 256) codebook is trained inside the run, on the card
C256_FLAGS = ["--network", "resnet50", "--dataset", "synthetic", "--quantizer", "hsq",
              "--c-dim", "256", "--k-bit", "8", "--n-bit", "6", "--num-users", "8",
              "--batch-size", "32", "--epochs", "1"]
C256_PER_STEP = {"hsq_rows_encode_wide": 2, "philox_uniform": 2, "hsq_rows_decode": 2}


def cli_c256_phase(entries, cache_dir: str, card: str):
    """``gqx_torch.cli.main`` at c_dim 256 with an empty codebook cache: the
    run trains the stem's codebook on the card, takes 16 steps (2 wide
    encodes, 2 uniform draws and 2 row decodes a step, K7 on the float32
    routes) and evaluates."""
    import os
    import re
    import shutil
    import tempfile

    from gqx_torch import codebooks

    use_codebook_cache(cache_dir)
    logdir = tempfile.mkdtemp(prefix="gqx_torch_c256_")
    try:
        per_step = {**dw_per_step("resnet50", "float32"), **C256_PER_STEP}
        state, _, text = cli_run(C256_FLAGS + ["--logdir", logdir], "cli c256",
                                 CLI_STEPS_PER_EPOCH, per_step, entries)
        if state.step != CLI_STEPS_PER_EPOCH:
            raise AssertionError(f"cli c256: the run ended at step {state.step}")
        name = codebooks.codebook_filename(KMEANS_DIM, KMEANS_K)
        if os.listdir(cache_dir) != [name]:
            raise AssertionError(f"cli c256: the cache holds {os.listdir(cache_dir)}")
        loop = re.search(r"training loop ([\d.]+) ms/step", text).group(1)
        log(f"[cli c256] the run trained {name} into the empty cache; training loop {loop} "
            f"ms/step | {card}")
    finally:
        shutil.rmtree(logdir, ignore_errors=True)


def native_phase(seed: int, card: str):
    """The port's native data library on the card's host: augment and
    normalize a CIFAR-sized global batch (8 x 32 uint8 images from the
    seed), a no-augment dataset equal to normalize, the host ms of the
    native and the numpy augment, pack / unpack equal to
    ``gqx_torch.ops.pack``'s at every width 1-32, and the Pipeline's
    default augment."""
    import numpy as np
    import torch

    from gqx_torch.config import GQConfig
    from gqx_torch.data import Pipeline
    from gqx_torch.data import native
    from gqx_torch.data.transforms import STATS, augment_batch, normalize
    from gqx_torch.ops import pack

    if not native.available():
        raise AssertionError("native: the library did not build")
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, size=(256, 32, 32, 3)).astype(np.uint8)
    out = native.augment_batch(x, "cifar10", np.random.default_rng(seed))
    mean, std = (np.asarray(v, np.float32) for v in STATS["cifar10"])
    lo, hi = float((-mean / std).min()), float(((1 - mean) / std).max())
    if out.shape != x.shape or out.dtype != np.float32 or not (lo - 1e-5 <= out.min()
                                                               and out.max() <= hi + 1e-5):
        raise AssertionError(f"native: augment {out.shape} {out.dtype} in [{out.min()}, "
                             f"{out.max()}], expected [{lo}, {hi}]")
    plain = native.augment_batch(x, "synthetic", np.random.default_rng(seed))
    if not np.allclose(plain, normalize(x, "synthetic"), rtol=1e-5, atol=1e-6) or \
            not np.allclose(native.normalize_batch(x, "cifar10"), normalize(x, "cifar10"),
                            rtol=1e-5, atol=1e-6):
        raise AssertionError("native: normalize differs from numpy's")

    def host_ms(fn, n=20):
        fn()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e3

    r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
    native_ms = host_ms(lambda: native.augment_batch(x, "cifar10", r1))
    numpy_ms = host_ms(lambda: augment_batch(x, "cifar10", r2))
    widths = 0
    for bits in range(1, 33):
        vals = rng.integers(0, 2 ** bits, size=4099, dtype=np.uint64).astype(np.uint32)
        words = native.pack_bits(vals, bits)
        want = pack.pack_bits(torch.from_numpy(vals.astype(np.int64)), bits)
        back = native.unpack_bits(words, bits, vals.size)
        ref = pack.unpack_bits(want, bits, vals.size).numpy().astype(np.uint32)
        if not (np.array_equal(words, want.numpy().view(np.uint32))
                and np.array_equal(back, vals) and np.array_equal(ref, vals)):
            raise AssertionError(f"native: pack / unpack differ from ops/pack.py at {bits} bits")
        widths += 1
    cfg = GQConfig(dataset="synthetic", num_users=8, batch_size=32,
                   dataset_kwargs=dict(num_train=256, num_test=64))
    augment = Pipeline(cfg).augment
    if augment != "native":
        raise AssertionError(f"native: the Pipeline took the {augment} augment")
    log(f"[native] cifar10 global batch 256 x 32x32x3: augment {native_ms:.3f} ms host "
        f"({native.num_threads()} OpenMP threads), numpy {numpy_ms:.3f} ms "
        f"({numpy_ms / native_ms:.1f}x); range [{out.min():.4f}, {out.max():.4f}]; normalize as "
        f"numpy's; pack / unpack equal to ops/pack.py at {widths} widths; Pipeline augment "
        f"{augment} | {card}")


# [mesh]: the distributed backend (gqx_torch.parallel.collectives) as one NCCL
# rank on the card, each run from P1's state, batch and seed, against the sim
# step of the same configuration; launches per step and compressed unit, as
# PATHS has them (the segmented ring at W = 1: one chunk encode, its
# uniforms, the gathered chunk's decode)
MESH_PATHS = {
    "mesh ps logical": (dict(backend="mesh"), PATHS["P1"][1]),
    "mesh ps packed": (dict(backend="mesh", wire="packed"), PATHS["P1"][1]),
    "mesh ps packed ef": (dict(backend="mesh", wire="packed", ef=True, two_phase=True),
                          PATHS["P2"][1]),
    "mesh ring": (dict(backend="mesh", mode="ring"), PATHS["P3"][1]),
    "mesh ring segmented": (dict(backend="mesh", mode="ring", ring_mode="segmented"),
                            dict(hsq_encode=1, philox_uniform=1, hsq_decode=1)),
}
# the packed payload of P1's plan a user and step (PERF.md section 2)
P1_WIRE_BYTES = 2_847_376


def _state_tensors(state):
    """Every tensor of a training state, by name."""
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    out.update({f"trace.{k}": v for k, v in state.trace.items()})
    for group in ("ef", "server_ef"):
        for i, t in enumerate(getattr(state.agg_state, group) or ()):
            out[f"{group}.{i}"] = t
    return out


def _first_difference(got, want):
    """(name, max |difference|) of the first tensor that is not bit-equal,
    or None."""
    import torch

    a, b = _state_tensors(got), _state_tensors(want)
    if a.keys() != b.keys():
        return "the state's tensors", None
    for k in a:
        if not torch.equal(a[k], b[k]):
            return k, float((a[k].float() - b[k].float()).abs().max())
    return None


def wire_timing(name, cfg, state, plan, batch, seed):
    """One step's signatures of every unit packed, gathered and unpacked as
    the packed PS step does: ms per user and step of each stage (device
    time where the stage launches kernels of its own, CUDA events), and the
    bytes the gather moved per user, held to ``plan.wire_bytes()``."""
    import torch

    from gqx_torch.compress.api import UserRows
    from gqx_torch.parallel import collectives

    x, y, _ = batch
    users = cfg.num_users
    _, grads = per_user_grads(cfg, state, plan, x, y)
    sigs = [u.compressor.compress_batch(g, UserRows(torch.Generator().manual_seed(seed), 0, users))
            for u, g in zip(plan.units, plan.pack(grads))]
    del grads

    def pack():
        return [collectives.pack_rows(u.compressor, sig) for u, sig in zip(plan.units, sigs)]

    packed = pack()

    def gather():
        return [collectives.gather_rows(rows, 1) for rows, _ in packed]

    gathered = gather()

    def unpack():
        return [collectives.unpack_rows(u.compressor, rows, layout)
                for u, rows, (_, layout) in zip(plan.units, gathered, packed)]

    shipped = sum(4 * rows.shape[1] for rows, _ in packed)
    if shipped != plan.wire_bytes() or shipped != P1_WIRE_BYTES:
        raise AssertionError(f"{name}: all_gather moved {shipped} B a user and step, "
                             f"wire_bytes {plan.wire_bytes()}, P1's {P1_WIRE_BYTES}")
    for u, sig, back in zip(plan.units, sigs, unpack()):
        if not _bit_equal(back, sig):
            raise AssertionError(f"{name}: a unit of {u.size} did not unpack bit for bit")
    times = {"pack_device": device_ms(pack, 3) / users, "pack_events": cuda_ms(pack, 3) / users,
             "all_gather_events": cuda_ms(gather, 3) / users,
             "unpack_device": device_ms(unpack, 3) / users,
             "unpack_events": cuda_ms(unpack, 3) / users}
    return shipped, times


def segmented_reference(cfg, state, plan, batch, seed):
    """One more step's per-user gradients and their segmented-ring aggregate
    on the card (one rank), kept on the host for ``segmented_check``."""
    import torch

    from gqx_torch.parallel import collectives

    x, y, _ = batch
    _, grads = per_user_grads(cfg, state, plan, x, y)
    comps = collectives.segment_compressors(cfg, plan, 1, x.device)
    chunks = collectives.segment_chunks(plan, 1)
    out = []
    for ui, g in enumerate(plan.pack(grads)):
        card = collectives._ring_unit_segmented(comps[ui], chunks[ui], g, None, 1.0,
                                                seed + ui, 0, 1)
        out.append((g.cpu(), card.cpu()))
    torch.cuda.synchronize()
    return out


def segmented_check(cfg, plan, ref):
    """The segmented ring's aggregates of ``segmented_reference`` recomputed
    on the CPU through the plain versions (a gloo group of one) from the
    same gradients and seeds: HSQ units may differ only on near-tie
    subvectors (at most 1e-3 of them, as ``aggregate_reference``), the
    identity unit within 1e-6 of the users' summed magnitudes."""
    import torch.distributed as dist

    from gqx_torch.parallel import collectives, distributed

    distributed.maybe_initialize(device="cpu", world_of_one=True)
    try:
        comps = collectives.segment_compressors(cfg, plan, 1, "cpu")
        chunks = collectives.segment_chunks(plan, 1)
        seed = ref[1]
        for ui, (g, card) in enumerate(ref[0]):
            cpu = collectives._ring_unit_segmented(comps[ui], chunks[ui], g, None, 1.0,
                                                   seed + ui, 0, 1)
            comp = comps[ui]
            if type(comp).__name__ == "HSQCompressor":
                bad, total = _subvectors_off(card, cpu, comp.dim), card.numel() // comp.dim
                limit, what = 1e-3 * total, "subvectors"
            else:
                tol = 1e-6 * g.float().abs().sum(0) + 1e-30
                bad, total = int(((card - cpu).abs() > tol).sum()), card.numel()
                limit, what = 0, "elements"
            log(f"[mesh ring segmented] {type(comp).__name__} chunk of {chunks[ui]}: {bad} of "
                f"{total} {what} differ from the CPU plain run (gloo, W=1)")
            if bad > limit:
                raise AssertionError(f"mesh ring segmented: {bad} of {total} {what} differ from "
                                     "the CPU plain run")
    finally:
        dist.destroy_process_group()


def mesh_phase(seed: int, steps: int, entries, card: str):
    """[mesh]: each run of MESH_PATHS at P1's full width (ResNet-50 8 x 32,
    bf16, 1 + ``steps`` steps) as one NCCL rank in process, beside the sim
    step of the same configuration from the same state, batch and seed.
    PS logical, PS packed (with and without EF and two-phase) and the chain
    ring must end bit-equal to the sim step (parameters, BN statistics,
    momentum, EF); where one does not, the sim step is run again to tell a
    fault from a step that does not repeat.  The segmented ring is held to
    its own CPU plain run.  Prints ms per step against the sim's, device
    ms, and for the packed runs pack, all_gather and unpack ms per user and
    step and the bytes gathered.  cuDNN is deterministic for the phase."""
    import torch
    import torch.distributed as dist

    from gqx_torch.parallel import distributed

    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    seg_ref = None
    distributed.maybe_initialize(device="cuda", world_of_one=True)
    try:
        log(f"[mesh] a {dist.get_backend()} group of {dist.get_world_size()} rank on "
            f"{torch.cuda.get_device_name(0)} | {card}")
        for name, (extra, per_step) in MESH_PATHS.items():
            cfg = canonical_config(**extra)
            sim_cfg = canonical_config(**{k: v for k, v in extra.items()
                                          if k not in ("backend", "wire", "ring_mode")})
            sim_ms, sim_losses, sim_state, *_ = run_steps(sim_cfg, seed, steps)
            ms, losses, state, plan, step, batch, launches = run_steps(cfg, seed, steps, counters)
            check_launches(name, cfg, plan, steps, launches, per_step, entries)
            if cfg.ring_mode == "segmented":
                verdict = "held to its CPU plain run below"
            else:
                diff = _first_difference(state, sim_state)
                if diff is not None or losses != sim_losses:
                    _, again, again_state, *_ = run_steps(sim_cfg, seed, steps)
                    repeat = _first_difference(again_state, sim_state)
                    raise AssertionError(
                        f"{name}: {diff} differs from the sim step (losses {losses} against "
                        f"{sim_losses}); the sim step run again differs from itself in "
                        f"{repeat} (None: it repeats, so the distributed step is at fault)")
                verdict = "parameters, BN statistics, momentum and EF bit-equal to the sim step"
            # the profiled step and the references below take the state on
            dev_ms = device_profile(state, step, batch, ms, top=3)
            log(f"[{name}] {ms:.2f} ms/step (sim {sim_ms:.2f}) over {steps} steps, device "
                f"{dev_ms if dev_ms is None else round(dev_ms, 3)} ms/step, losses "
                f"{[round(v, 4) for v in losses]}; {verdict}")
            if cfg.ring_mode == "segmented":
                seg_ref = (segmented_reference(cfg, state, plan, batch, seed), seed)
                seg_cfg, seg_plan = cfg, plan
            if cfg.wire == "packed":
                shipped, times = wire_timing(name, cfg, state, plan, batch, seed)
                log(f"[{name}] all_gather moved {shipped} B a user and step = wire_bytes "
                    f"{plan.wire_bytes()}; ms per user and step: "
                    + json.dumps({k: round(v, 4) for k, v in times.items()}))
            elif cfg.mode == "ps":
                log(f"[{name}] all_reduce moved {4 * sum(u.size for u in plan.units)} B a rank "
                    "and step (the float32 means)")
            del state, sim_state, step, batch
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        cudnn.deterministic, cudnn.benchmark = saved
    segmented_check(seg_cfg, seg_plan, seg_ref)


def cli_mesh_phase(entries):
    """[cli mesh]: the [cli] drive's command line on the distributed backend
    with the packed wire, one NCCL process over a TCP rendezvous on
    localhost: 16 steps and an eval, the [cli] drive's launches a step."""
    import shutil
    import socket
    import tempfile

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    logdir = tempfile.mkdtemp(prefix="gqx_torch_cli_mesh_")
    try:
        argv = CLI_FLAGS + ["--epochs", "1", "--logdir", logdir, "--backend", "mesh",
                            "--wire", "packed", "--coordinator-address", f"127.0.0.1:{port}",
                            "--num-processes", "1", "--process-id", "0"]
        per_step = {**dw_per_step("resnet50", "float32"), **HSQ_PER_STEP}
        state, _, _ = cli_run(argv, "cli mesh", CLI_STEPS_PER_EPOCH, per_step, entries)
        if state.step != CLI_STEPS_PER_EPOCH:
            raise AssertionError(f"cli mesh: the run ended at step {state.step}")
    finally:
        shutil.rmtree(logdir, ignore_errors=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    from gqx_torch.ops import _build

    card = card_line()
    log(f"[card] {card}")
    log(f"[versions] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    build_s = _build.build()
    log(f"[build] nvcc, {len(_build.SOURCES)} sources in parallel: {build_s:.1f} s")

    entries = kernel_phase(args.seed)
    torch.cuda.empty_cache()
    entries.update(rows_kernel_phase(args.seed))
    torch.cuda.empty_cache()
    entries.update(dw_kernel_phase(args.seed))
    torch.cuda.empty_cache()
    log_entries(entries)
    for e in entries.values():
        e["launches"], e["launches_by_path"] = 0, {}
    cache_root = tempfile.mkdtemp(prefix="gqx_torch_codebooks_")
    try:
        use_codebook_cache(os.path.join(cache_root, "kmeans"))
        kmeans_phase(args.seed, card)
        torch.cuda.empty_cache()
        paths_and_phases(args, entries, card, cache_root)
    finally:
        shutil.rmtree(cache_root, ignore_errors=True)

    order = ("hsq_encode", "hsq_decode_mean", "philox_uniform", "hsq_decode",
             "hsq_rows_encode_tc", "hsq_rows_encode_wide", "hsq_rows_decode", "per_user_dw",
             "per_user_dw_tc", "per_user_dw_narrow", "per_user_dw_tc_f32", "per_user_dw_narrow_f32")
    lost = collections.Counter(PAD_CALLS - p for p in PADS_SEEN)
    log(f"[profile] {len(PADS_SEEN)} profiled windows; leading spin kernels lost per window "
        f"(lost: windows): {dict(sorted(lost.items()))}")
    log(f"[time] chip_smoke.py: {time.perf_counter() - start:.1f} s wall, the build included")
    print(json.dumps({"kernels": [entries[k] for k in order]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def paths_and_phases(args, entries, card: str, cache_root: str):
    """The training paths (P12 with the codebook [kmeans] trained), P6, the
    folded-against-looped comparison, the comparison configurations, [cli],
    [cli c256], [bench], [wire] and [native]."""
    import torch

    for name, (extra, per_step) in PATHS.items():
        cfg = canonical_config(**extra)
        steps = args.steps if cfg.folded_users else 1
        ms, losses, state, plan, step, batch, launches = run_steps(cfg, args.seed, steps, counters)
        log(f"[slice {name}] {cfg.network} 8x32 {cfg.quantizer} {extra or 'canonical'} "
            f"{cfg.compute_dtype}: "
            f"{ms:.2f} ms/step over {steps} steps, losses {[round(v, 4) for v in losses]}, "
            f"wire {plan.wire_bytes()} B/user/step")
        log(f"[slice {name}] launches: {launches}")
        log(f"[slice {name}] conv weight gradient launches by route over {steps} steps: "
            f"{ {k: v for k, v in launches.items() if k.startswith('per_user_dw')} }")
        check_launches(name, cfg, plan, steps, launches, per_step, entries)
        if name == "P12":
            units = [(type(u.compressor).__name__, u.size, getattr(u.compressor, "dim", None),
                      getattr(u.compressor, "K", None)) for u in plan.units]
            log(f"[slice P12] units (kind, elements, rows of dim, K): {units} | {card}")
            stem_rows_check(state, plan, cfg, batch, entries)
        if name in ("P1", "P7"):
            breakdown_and_reference(cfg, state, plan, step, batch, args.seed, ms)
            if name == "P1":
                eval_check(state, batch)
        elif cfg.folded_users:
            aggregate_reference(name, cfg, state, plan, step, batch, args.seed, ms)
            if name in SPLIT_PATHS:
                device_split_phase(name, state, step, batch, ms)
        else:
            device_profile(state, step, batch, ms)
        del state, step, batch
        torch.cuda.empty_cache()
    mesh_phase(args.seed, args.steps, entries, card)
    torch.cuda.empty_cache()
    for kernel, count in wide_rows_path(args.seed).items():
        entries[kernel]["launches"] += count
        entries[kernel]["launches_by_path"]["P6"] = count
    torch.cuda.empty_cache()
    # the float32 folded gradients of the comparison with the loop run the
    # float32 routes of K7 too
    for label, got in folded_vs_looped(args.seed).items():
        if "float32" in label:
            for kernel in ("per_user_dw_narrow_f32", "per_user_dw_tc_f32"):
                entries[kernel]["launches"] += got[kernel]
                entries[kernel]["launches_by_path"][label] = got[kernel]
    torch.cuda.empty_cache()
    for e in entries.values():
        if e["launches"] < 1 and "baseline_of" not in e:
            raise AssertionError(f"{e['name']} was launched on no path")

    comparison_phase(args.seed, args.steps, entries)
    torch.cuda.empty_cache()
    runner_ms = cli_phase(entries, args.seed)
    torch.cuda.empty_cache()
    cli_mesh_phase(entries)
    torch.cuda.empty_cache()
    cli_c256_phase(entries, os.path.join(cache_root, "cli"), card)
    torch.cuda.empty_cache()
    bench_phase(entries, runner_ms)
    torch.cuda.empty_cache()
    wire_phase(args.seed)
    native_phase(args.seed, card)


if __name__ == "__main__":
    main()
