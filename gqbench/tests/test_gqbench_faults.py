"""The check against the faults a cell can have and against the control,
at a tiny size on the CPU: each must come out not correct.  A fault is
planted by the cell's traffic file (``plant``), as a run would read it."""

import pytest

from gqbench.harness import cell, check, manifest
from gqbench.reference import step as ref_step

SEED = 2200000012


@pytest.mark.parametrize("workload", ["tiny.hsq.unchanged", "tiny.hsq.half_batch",
                                      "tiny.hsq.k7_scaled"],
                         ids=["state_unchanged", "half_batch", "k7_scaled"])
def test_a_broken_step_is_not_correct(tiny, workload):
    result = cell.launch(workload, SEED, 0.2, False, "cpu", 0.0)
    assert result["correct"] is False, result["checks"]


def test_the_k7_fault_fails_the_k7_family(tiny):
    """A tenth off the stride-1 convs' weight gradients shows in their own
    family, though the median of all leaves barely moves."""
    result = cell.launch("tiny.hsq.k7_scaled", SEED, 0.2, False, "cpu", 0.0)
    k7 = result["checks"]["grad.k7"]
    assert k7["value"] > k7["limit"], result["checks"]
    conv = result["checks"]["grad.conv"]
    assert conv["value"] <= conv["limit"], result["checks"]


def test_the_exchange_left_out_is_not_correct(tiny):
    result = cell.launch("tiny.mesh2.no_exchange", SEED, 0.2, False, "cpu", 0.0)
    assert result["device"]["count"] == 2
    assert result["correct"] is False, result["checks"]


def test_the_two_rank_run_is_correct(tiny):
    result = cell.launch("tiny.mesh2", SEED, 0.2, False, "cpu", 0.0)
    assert result["device"]["count"] == 2
    assert result["correct"] is True, result["checks"]


def test_a_plant_outside_the_tests_is_refused():
    with pytest.raises(ValueError, match="only gqbench.tests.plants"):
        cell._plant({"plant": "os.abort"})


@pytest.mark.parametrize("workload", ["tiny.hsq", "tiny.pvq"])
def test_the_control_in_fp8_is_not_correct(tiny, workload):
    """The reference in the program's place, computing in float8 (the
    precision below the configuration's bf16)."""
    w = manifest.workload(manifest.benchmark(), workload)
    spec, mix = manifest.config(w["config"]), manifest.traffic(w["traffic"])
    data = ref_step.Data(mix["data"], SEED)
    truth = cell.reference(spec, mix, SEED, "cpu", data)
    control = cell.reference(spec, mix, SEED, "cpu", data, quant=ref_step.fp8_quant())
    judged = cell.verdict(control, truth, spec, workload)
    assert not check.passed(judged), judged
