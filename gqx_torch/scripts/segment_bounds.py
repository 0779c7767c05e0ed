"""Time the per-segment min/max of the norm quantizer on the canonical unit.

    python -m gqx_torch.scripts.segment_bounds [--device cuda] [--reps 20]

The canonical ResNet-50 HSQ unit has 77 norm segments over 1,470,464
subvector norms per user, 8 users.  This compares two ways of computing the
segment bounds of an (8, 1,470,464) float32 tensor, checks that they agree
exactly, and prints the time of each (CUDA events on a CUDA device, the host
clock on the CPU):

- ``two_stage``: the plan ``ProbabilisticScalarCompressor`` uses
  (``gqx_torch.compress.scalar._SegmentPlan``): a gather of every segment
  into blocks of 1,024 rows, an ``aminmax`` per block, then the same over
  the block results of each segment;
- ``segment_reduce``: ``torch.segment_reduce`` with ``"min"`` and ``"max"``,
  one call per bound over every user.
"""

from __future__ import annotations

import argparse
import json
import time

import torch


def segment_reduce_bounds(vec, lengths):
    lens = lengths.expand(vec.shape[:-1] + lengths.shape)
    axis = vec.dim() - 1
    return (torch.segment_reduce(vec, "min", lengths=lens, axis=axis),
            torch.segment_reduce(vec, "max", lengths=lens, axis=axis))


def timed_ms(fn, reps, device):
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    from gqx_torch import resolve_device
    from gqx_torch.compress.scalar import _segment_plan
    from gqx_torch.config import GQConfig
    from gqx_torch.convert import leaf_paths
    from gqx_torch.models import create_model
    from gqx_torch.parallel.packing import plan_units

    dev = resolve_device(args.device)
    cfg = GQConfig(network="resnet50", num_users=8, quantizer="hsq", c_dim=16, k_bit=8,
                   n_bit=6, compute_dtype="bfloat16")
    model = create_model("resnet50", 10, "bfloat16", torch.Generator().manual_seed(args.seed))
    plan = plan_units([(n, tuple(p.shape)) for n, p in model.named_parameters()],
                      leaf_paths(model), cfg)
    norm = plan.units[0].compressor.norm_compressor
    segs = norm.segment_sizes
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    vec = torch.randn((cfg.num_users, sum(segs)), generator=gen, device=dev)
    lengths = torch.tensor(segs, dtype=torch.long, device=dev)
    two = _segment_plan(segs, dev)
    a = segment_reduce_bounds(vec, lengths)
    b = two.bounds(vec)
    equal = all(torch.equal(x, y) for x, y in zip(a, b))
    if not equal:
        raise AssertionError("segment_reduce and the two-stage plan disagree")
    out = {
        "shape": list(vec.shape), "segments": len(segs), "device": str(dev),
        "segment_reduce_ms": timed_ms(lambda: segment_reduce_bounds(vec, lengths), args.reps, dev),
        "two_stage_ms": timed_ms(lambda: two.bounds(vec), args.reps, dev),
        "equal": equal,
    }
    if dev.type == "cuda":
        out["card"] = torch.cuda.get_device_name(dev)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
