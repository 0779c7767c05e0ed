"""The plain reference against the port at a tiny size on the CPU, and a
whole run of the harness there (the look for a chip skipped)."""

import json

import pytest
import torch

from gqbench.harness import cell, manifest
from gqbench.reference import model as ref_model
from gqbench.reference import philox

SEED = 2200000011
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def test_philox_draws_the_ports_uniforms():
    from gqx_torch.ops.rand import uniform_plain

    for seed in (1, 2 ** 61 + 12345):
        ours = philox.uniform(seed, (3, 37), "cpu")
        theirs = uniform_plain(seed, 0, (3, 37), "cpu")
        assert torch.equal(ours, theirs)
    g1, g2 = torch.Generator().manual_seed(SEED), torch.Generator().manual_seed(SEED)
    from gqx_torch.compress.api import draw_seed

    assert philox.draw_seed(g1) == draw_seed(g2)


@pytest.mark.parametrize("config,network", [("resnet50-cifar.bf16", "resnet50"),
                                            ("vgg16-cifar.bf16", "vgg16")])
def test_reference_forward_equals_the_ports_in_float32(config, network):
    from gqx_torch.convert import leaf_paths
    from gqx_torch.models import create_model

    spec = manifest.config(config)
    weights = ref_model.init_weights(spec, SEED, "cpu")
    model = create_model(network, 10, "float32").train()
    paths = leaf_paths(model)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(weights[paths[n]])
    x = torch.randn(4, 3, 32, 32, generator=torch.Generator().manual_seed(3))
    rec = ref_model.Recorder()
    ours = ref_model.forward(spec, weights, x, rec)
    theirs = model(x)
    assert torch.allclose(ours, theirs, rtol=1e-4, atol=1e-4)
    assert len(rec.stats) == len(ref_model.bn_paths(spec))


@pytest.mark.parametrize("workload", ["tiny.hsq", "tiny.pvq"])
def test_a_tiny_run_on_the_cpu_is_correct_and_prints_the_contracts_keys(tiny, workload, capsys):
    result = cell.launch(workload, SEED, 0.5, False, "cpu", 0.0)
    cell.lines(result)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == RESULT_KEYS
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"samples_per_s", "step_ms_p90", "setup_s"}
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert err.strip().splitlines()[-1].startswith("check bn_stats:")
    assert not cell.forbidden_modules()
