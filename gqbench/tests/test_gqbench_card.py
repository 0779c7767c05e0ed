"""On the card only: each cell of BENCHMARK.json runs a short window end
to end and reads correct.  Skips without a CUDA device."""

import json
import os
import subprocess
import sys

import pytest

from gqbench.harness import manifest

CELLS = [w["name"] for w in manifest.benchmark()["workloads"] if w["chips"] == 1]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_a_short_run_on_the_card_is_correct(card, workload):
    out = subprocess.run(
        [sys.executable, os.path.join(manifest.BENCH_DIR, "run.py"), "--workload", workload,
         "--seed", "4300000001", "--seconds", "3", "--trace", "0"],
        cwd=manifest.ROOT, capture_output=True, text=True, timeout=1200, check=True)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
