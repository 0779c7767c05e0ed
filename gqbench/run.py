"""The benchmark of gqx_torch: one run of one cell.

    python3 gqbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA devices the cell
asks for.  It builds the cell's training run from the seed (set-up, timed
as ``setup_s``: imports, the data set, the model and state, the first
three steps, which the check compares, and one more), trains for
``--seconds`` seconds of host time with no synchronise of its own, then
checks the first steps against the plain reference, and prints the result
as one JSON line, last on standard output.  With ``--trace 0`` the line
holds the cell's end-to-end metrics; with ``--trace 1`` a profiled window
of steady steps follows the measured one and the line holds the per-layer
metrics, the device's busy and window seconds and a breakdown.

It exits with 2 and prints no result where the machine lacks the devices,
and with 3 where the process holds JAX or the JAX package after the window.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    if args.seed < 0:
        raise SystemExit("--seed must be a non-negative whole number")
    from gqbench.harness import cell, manifest

    chips = manifest.workload(manifest.benchmark(), args.workload)["chips"]
    why = cell.environment_ok(chips)
    if why is not None:
        cell.log(f"cannot run {args.workload}: {why}")
        return 2
    cell.log(f"[card] {cell.card_line()}")
    result = cell.launch(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    found = cell.forbidden_modules()
    if found:
        cell.log(f"the run holds {found}: the benchmark may load neither JAX nor the JAX package")
        return 3
    cell.lines(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
