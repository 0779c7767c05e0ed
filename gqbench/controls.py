"""Readings that set the limits of a cell's correctness check, on the chip at
the cell's own size.

    python3 gqbench/controls.py --workload <name> --seeds 1,2,3 [--program 1]
        [--faults 1] [--raw out.jsonl]

For each seed it computes the reference's readings of the first three steps
(float32, TF32 off) and judges against them, as a run does
(``cell.reference``, ``cell.verdict``):
  - with ``--program 1``, the program's own first three steps (sound runs:
    the lower reading of each number is the largest over a dozen seeds);
  - with ``--faults 1``: the control, the reference in the program's place
    with its products in float8 (the precision below the configuration's
    bf16); the reference training each user on half of its micro-batch
    (the mean taken over the rest); the program with the per-user weight
    gradient of its stride-1 convolutions (K7) a tenth short, and zero; a
    step that leaves the state unchanged; and the witness, the float32
    reference judged against itself computed in float64.
One JSON line a seed and reading: {"seed", "what", "numbers", "passed",
"look"}; ``--raw`` also writes every reading's per-leaf norms.  The
benchmark's own runs never run this.
"""

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _unchanged(ref: dict) -> dict:
    """The readings of a step that returns its state unchanged."""
    zero = lambda d: {k: 0.0 for k in d}  # noqa: E731
    return dict(losses=ref["losses"], grad=zero(ref["grad"]), change=zero(ref["change"]),
                bn_stats=zero(ref["bn_stats"]))


def _program(spec, mix, seed: int, device, plant=None) -> dict:
    import torch

    from gqbench.harness.cell import CHECKED_STEPS
    from gqbench.harness.program import Session
    from gqbench.tests import plants

    if plant is not None:
        plant()
    try:
        session = Session(spec, mix, seed, device)
        out = session.checked_steps(CHECKED_STEPS)
        del session
    finally:
        plants.restore()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def readings(workload: str, seed: int, program: bool, faults: bool, device):
    """[(what, readings, reference)] of one seed: each reading with the
    reference it is judged against."""
    import torch

    from gqbench.harness import cell, manifest
    from gqbench.reference import step as ref_step
    from gqbench.tests import plants

    w = manifest.workload(manifest.benchmark(), workload)
    spec, mix = manifest.config(w["config"]), manifest.traffic(w["traffic"])
    out = []
    if program:
        out.append(("program", _program(spec, mix, seed, device)))
    if faults:
        out.append(("fault_k7_scaled", _program(spec, mix, seed, device, plants.k7_scaled)))
        out.append(("fault_k7_zero", _program(spec, mix, seed, device, plants.k7_zero)))
    data = ref_step.training_data(spec, mix["data"], seed)
    truth = cell.reference(spec, mix, seed, device, data)
    out = [(what, got, truth) for what, got in out]
    if faults:
        out.append(("control_fp8", cell.reference(spec, mix, seed, device, data,
                                                  quant=ref_step.fp8_quant()), truth))
        out.append(("fault_half_batch", cell.reference(spec, mix, seed, device, data,
                                                       half=True), truth))
        out.append(("fault_unchanged", _unchanged(truth), truth))
        exact = cell.reference(spec, mix, seed, device, data, dtype=torch.float64)
        out.append(("witness_f32_vs_f64", truth, exact))
    return spec, w["name"], out


def main(argv=None) -> int:
    import torch

    from gqbench.harness import cell, check
    from gqbench.reference import model as ref_model

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--program", type=int, default=0)
    p.add_argument("--faults", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--raw", default=None, help="append every reading's norms here")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    raw = open(args.raw, "a") if args.raw else None
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        spec, name, got = readings(args.workload, seed, bool(args.program), bool(args.faults),
                                   device)
        families = ref_model.leaf_families(spec)
        for what, prog, ref in got:
            judged = cell.verdict(prog, ref, spec, name)
            print(json.dumps({"workload": name, "seed": seed, "what": what,
                              "numbers": {k: v["value"] for k, v in judged.items()},
                              "passed": check.passed(judged),
                              "look": check.look(prog, ref, families)}), flush=True)
            if raw is not None:
                raw.write(json.dumps({"workload": name, "seed": seed, "what": what,
                                      "readings": prog, "reference": ref}) + "\n")
                raw.flush()
        print(f"[seed {seed}] {time.perf_counter() - t:.1f} s", file=sys.stderr, flush=True)
    if raw is not None:
        raw.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
