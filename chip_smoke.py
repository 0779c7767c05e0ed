#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gqx_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--steps N]

1. Prints the card (nvidia-smi name and power limit) and the torch/CUDA
   versions.
2. Builds the three kernels from gqx_torch/csrc with nvcc (one process per
   source, all at once) and prints the build time.
3. Holds each kernel against its plain PyTorch version at the shapes of the
   canonical ResNet-50 HSQ unit (8 users, bf16 input, passes=1; plus a
   float32 input at passes=2), and times kernel, plain version and, where
   one exists, the single PyTorch call computing the same function.
4. Runs the canonical training step (CIFAR ResNet-50, 8 users x 32, HSQ
   c_dim 16 / k_bit 8 / n_bit 6, bf16 compute, random weights and data from
   --seed): one warm-up step, then --steps steps with the launch counters
   set to 0 just before and read just after, then the fp32-wire ``sgd`` step
   of the same package for comparison.  The aggregate of one more step is
   recomputed on the CPU through the plain versions and compared.
5. Prints the ``kernels`` JSON line, the card line and, last, the result
   line {"ok": true, "device": {...}}.

Any failed check raises, so the script exits non-zero and prints no result
line; without a CUDA device it exits at once.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

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


def bound(bytes_moved: float, ops: float, peak_ops: float):
    t_bytes = bytes_moved / HBM_BPS * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def canonical_config(quantizer: str = "hsq"):
    from gqx_torch.config import GQConfig

    extra = dict(c_dim=16, k_bit=8, n_bit=6) if quantizer == "hsq" else {}
    return GQConfig(network="resnet50", dataset="synthetic", num_users=8,
                    batch_size=32, quantizer=quantizer, compute_dtype="bfloat16",
                    hsq_passes=1, **extra)


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


def kernel_phase(seed: int):
    """Each kernel against its plain version at the main path's shapes."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from gqx_torch.convert import leaf_paths
    from gqx_torch.models import create_model
    from gqx_torch.ops import hsq as hsq_ops
    from gqx_torch.ops import rand as rand_ops
    from gqx_torch.parallel.packing import plan_units

    cfg = canonical_config()
    model = create_model("resnet50", 10, "bfloat16", torch.Generator().manual_seed(seed))
    plan = plan_units([(n, tuple(p.shape)) for n, p in model.named_parameters()],
                      leaf_paths(model), cfg)
    unit = plan.units[0]
    comp = unit.compressor
    users, size, m, dim, k = cfg.num_users, unit.size, comp.M, comp.dim, comp.K
    log(f"[unit] ResNet-50 HSQ unit: {len(unit.sizes)} leaves, {size} elements "
        f"(pad {unit.pad}), M={m} subvectors of {dim}, K={k}, "
        f"{comp.norm_compressor.n_segments} norm segments")
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    # gradient-like input: per-leaf scales spread over two decades
    x32 = torch.from_numpy(rng.standard_normal((users, size), dtype=np.float32)).to(dev)
    scales = torch.from_numpy(10.0 ** rng.uniform(-4, -2, len(unit.sizes) + 1).astype(np.float32))
    lengths = torch.tensor(list(unit.sizes) + [unit.pad])
    x32 *= torch.repeat_interleave(scales, lengths).to(dev)
    x32[:, sum(unit.sizes):] = 0.0  # the pad is zero, as pack() makes it
    xb = x32.to(torch.bfloat16)
    cb = comp.codebook(dev)
    entries = {}

    # K1: canonical bf16 input, passes=1
    u_k, c_k, err1 = check_encode(xb, comp, 1, "hsq_encode bf16 passes=1")
    ms = cuda_ms(lambda: hsq_ops.hsq_encode_flat(xb, cb, dim, 1, comp.code_dtype), 10)
    plain = cuda_ms(lambda: hsq_ops.hsq_encode_flat_plain(xb, cb, dim, 1, comp.code_dtype), 2)
    b, by = bound(users * size * 2 + users * m * 5 + k * dim * 4,
                  2.0 * users * m * k * dim, BF16_FLOPS)
    entries["hsq_encode"] = dict(
        name="hsq_encode", route="cuda", source="gqx_torch/csrc/hsq_encode.cu",
        replaces="gqx/ops/pallas_hsq4.py:87", max_abs_err=err1, ms=ms, plain_ms=plain,
        bound_ms=b, bound_by=by, library_ms=None)
    # K1 at passes=2 on a float32 input (gqx's strict-parity mode)
    _, _, err2 = check_encode(x32, comp, 2, "hsq_encode f32 passes=2")
    ms2 = cuda_ms(lambda: hsq_ops.hsq_encode_flat(x32, cb, dim, 2, comp.code_dtype), 5)
    log(f"[hsq_encode f32 passes=2] {ms2:.3f} ms")

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
    entries["philox_uniform"] = dict(
        name="philox_uniform", route="cuda", source="gqx_torch/csrc/philox_uniform.cu",
        replaces="gqx/ops/pallas_rand.py:129", max_abs_err=0.0,
        ms=cuda_ms(lambda: rand_ops.uniform(7, 0, (users, m), dev), 20),
        plain_ms=cuda_ms(lambda: rand_ops.uniform_plain(7, 0, (users, m), dev), 3),
        bound_ms=b, bound_by=by,
        library_ms=cuda_ms(lambda: torch.rand((users, m), generator=gen, device=dev), 20))

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
    entries["hsq_decode_mean"] = dict(
        name="hsq_decode_mean", route="cuda", source="gqx_torch/csrc/hsq_decode_mean.cu",
        replaces="gqx/ops/pallas_hsq4.py:252", max_abs_err=float(err.max()),
        ms=cuda_ms(lambda: hsq_ops.hsq_decode_mean(c_k, u_q, cb, dim, 1), 20),
        plain_ms=cuda_ms(lambda: hsq_ops.hsq_decode_mean_plain(c_k, u_q, cb, dim, 1), 2),
        bound_ms=b, bound_by=by,
        library_ms=cuda_ms(lambda: F.embedding_bag(codes_t, cb, per_sample_weights=w_t,
                                                    mode="sum"), 20))
    for e in entries.values():
        log(f"[{e['name']}] {e['ms']:.4f} ms (bound {e['bound_ms']:.4f} ms by {e['bound_by']}), "
            f"plain {e['plain_ms']:.3f} ms, library {e['library_ms']}")
    return entries


def run_steps(quantizer: str, seed: int, steps: int, count_fn=None):
    """Build the canonical model and take 1 + ``steps`` steps; returns
    (ms/step, losses, state, plan, step_fn, batch, launches)."""
    import numpy as np
    import torch

    from gqx_torch.models import create_model
    from gqx_torch.train import create_train_state, make_train_step

    cfg = canonical_config(quantizer)
    model = create_model(cfg.network, cfg.num_classes, cfg.compute_dtype,
                         torch.Generator().manual_seed(seed))
    state, plan = create_train_state(cfg, model, device="cuda")
    step = make_train_step(cfg, plan)
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    x = torch.from_numpy(rng.standard_normal(
        (cfg.num_users, cfg.batch_size, 3, 32, 32), dtype=np.float32)).to(dev)
    y = torch.from_numpy(rng.integers(0, 10, (cfg.num_users, cfg.batch_size))).to(dev)
    gen = torch.Generator().manual_seed(seed + 1)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
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
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{quantizer}: non-finite loss {losses}")
    changed = sum(int(not torch.equal(before[n], p)) for n, p in model.named_parameters())
    if changed != len(before):
        raise AssertionError(f"{quantizer}: only {changed} of {len(before)} parameters changed")
    finite = all(bool(torch.isfinite(p).all()) for p in model.parameters())
    if not finite:
        raise AssertionError(f"{quantizer}: non-finite parameters")
    return ms, losses, state, plan, step, (x, y, gen), launches


def counters(reset=False):
    from gqx_torch.ops import hsq as hsq_ops
    from gqx_torch.ops import rand as rand_ops

    if reset:
        for key in hsq_ops.launches:
            hsq_ops.launches[key] = 0
        rand_ops.launches = 0
        return None
    return {**hsq_ops.launches, "philox_uniform": rand_ops.launches}


def device_profile(state, step, batch, ms_step):
    """Device time of one step from torch.profiler (CUDA activity): the sum
    of kernel self times, its share of the unprofiled step time, and the
    kernels that take most of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    x, y, gen = batch
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, x, y, 0.1, 5e-4, gen)
        torch.cuda.synchronize()
    rows = [(getattr(e, "self_device_time_total", 0.0), e.count, e.key)
            for e in prof.key_averages()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    device_ms = sum(r[0] for r in rows) / 1e3
    if device_ms == 0.0:
        log("[profile] the profiler saw no device time: device busy share not measured")
        return
    log(f"[profile] device kernel time {device_ms:.2f} ms per step = "
        f"{100 * device_ms / ms_step:.1f}% of the {ms_step:.2f} ms step; "
        f"{sum(r[1] for r in rows)} kernel launches")
    for t, n, key in sorted(rows, reverse=True)[:8]:
        log(f"[profile]   {t / 1e3:8.3f} ms  x{n:<5d} {key[:90]}")


def breakdown_and_reference(state, plan, step, batch, seed, ms_step):
    """One more step, stage by stage with a synchronise after each stage
    (host clock), then its aggregate recomputed on the CPU through the plain
    versions from the same per-user gradients and seed.  HSQ units may
    differ only on a few subvectors (near-tie codes, level boundaries);
    identity units must agree to 1e-6 of the summed magnitudes."""
    import torch

    from gqx_torch.models.common import update_running_stats
    from gqx_torch.train import fused_sgd_update, user_grads

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

    _, grads = timed("user_fwd_bwd", lambda: user_grads(model, plan.names, x, y))
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()

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

    ms_hsq, losses, state, plan, step, batch, launches = run_steps(
        "hsq", args.seed, args.steps, counters)
    log(f"[slice] resnet50 8x32 hsq bf16: {ms_hsq:.2f} ms/step over {args.steps} steps, "
        f"losses {[round(v, 4) for v in losses]}, wire {plan.wire_bytes()} B/user/step")
    log(f"[slice] launches on the main path: {launches}")
    hsq_units = sum(1 for u in plan.units if type(u.compressor).__name__ == "HSQCompressor")
    for name, count in launches.items():
        if count != args.steps * hsq_units:
            raise AssertionError(f"{name} launched {count} times in {args.steps} steps")
        entries[name]["launches"] = count
    breakdown_and_reference(state, plan, step, batch, args.seed, ms_hsq)
    del state
    torch.cuda.empty_cache()

    ms_sgd, sgd_losses, _, sgd_plan, _, _, _ = run_steps("sgd", args.seed, args.steps)
    log(f"[slice] resnet50 8x32 sgd (fp32 wire) bf16: {ms_sgd:.2f} ms/step, "
        f"losses {[round(v, 4) for v in sgd_losses]}, wire {sgd_plan.wire_bytes()} B/user/step")

    order = ("hsq_encode", "hsq_decode_mean", "philox_uniform")
    print(json.dumps({"kernels": [entries[k] for k in order]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
