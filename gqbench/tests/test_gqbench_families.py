"""Model families found by name: a family added by new files alone (the
tests' FCN, under ``data/families/``) runs end to end, the image families
count and lay out what they did before they were moved into their modules,
and the harness names no family."""

import ast
import hashlib
import json
import os
import re

import pytest

from gqbench.harness import cell, check, counts, manifest
from gqbench.reference import model as ref_model

SEED = 2200000013
TESTS = os.path.dirname(os.path.abspath(__file__))
FAMILY_DIRS = [os.path.join(manifest.BENCH_DIR, "families"),
               os.path.join(TESTS, "data", "families")]
FORBIDDEN = {"jax", "jaxlib", "flax", "gqx", "gqx_torch"}

#: taken before the families moved out of the reference: MACs an image,
#: parameters, the sorted leaves (path, shape, bound) as JSON, their
#: sha256, and the least ms of the per-user dW and of the HSQ encode in
#: each of the config's cells
AT_PARENT = {
    "resnet50-cifar.bf16": dict(
        macs=1_297_829_888, parameters=23_520_842, leaves=161,
        digest="4d64bef860801d6b41eb3377214c63d2f357b7a248afe80f5614c8070f28fd61",
        least={"hsq-d16.ps32x32": (1.1123037842893921, 0.519715152238806),
               "pvq-d16.ps16x32": (0.5561518921446961, 4.890746268656716e-06)}),
    "vgg16-cifar.bf16": dict(
        macs=313_201_664, parameters=14_728_266, leaves=54,
        digest="f862614e975cbc16b30ec89ae5ae231c226dc3d05c82fc6aeb8afa4e44196d72",
        least={"hsq-d16.ps64x32": (1.9341716863789447, 0.6514522937313433)}),
}


def test_the_fcn_family_runs_end_to_end_on_the_cpu(tiny, capsys):
    """A family with no convolution, no batch norm and no running
    statistics: its cell gives no k7, bn or bn_stats number."""
    result = cell.launch("tiny.fcn", SEED, 0.5, False, "cpu", 0.0)
    cell.lines(result)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert list(line["checks"]) == ["loss", "grad.dense", "change.dense"]
    assert set(line["metrics"]) == {"samples_per_s", "step_ms_p90", "setup_s"}


@pytest.mark.parametrize("change", ["extra", "lacking"])
def test_a_limits_file_that_does_not_list_the_cells_numbers_fails_the_run(tiny, monkeypatch,
                                                                          change):
    limits = manifest.limits

    def edited(workload):
        out = dict(limits(workload))
        if change == "extra":
            out["bn_stats"] = {"limit": 1.0}
        else:
            del out["change.dense"]
        return out

    monkeypatch.setattr(manifest, "limits", edited)
    result = cell.launch("tiny.fcn", SEED, 0.2, False, "cpu", 0.0)
    assert result["checks"]["limits_unmatched"] == {"value": 1, "limit": 0}
    assert result["correct"] is False


def _cells(bench_file, data_dir, monkeypatch):
    monkeypatch.setattr(manifest, "BENCHMARK_FILE", bench_file)
    monkeypatch.setattr(manifest, "DATA_DIR", data_dir)
    return manifest.benchmark()["workloads"]


@pytest.mark.parametrize("where", ["benchmark", "tests"])
def test_each_limits_file_lists_exactly_its_cells_numbers(where, monkeypatch):
    if where == "tests":
        cells = _cells(os.path.join(TESTS, "data", "BENCHMARK.json"),
                       os.path.join(TESTS, "data"), monkeypatch)
    else:
        cells = manifest.benchmark()["workloads"]
    for w in cells:
        spec = manifest.config(w["config"])
        want = check.cell_numbers(ref_model.leaf_families(spec), ref_model.family(spec).FAMILIES,
                                  bool(ref_model.running_stats(spec)))
        assert set(manifest.limits(w["name"])) == set(want), w["name"]


@pytest.mark.parametrize("config", sorted(AT_PARENT))
def test_the_image_families_count_and_draw_as_before_they_moved(config):
    spec, want = manifest.config(config), AT_PARENT[config]
    assert counts.macs_per_image(spec) == want["macs"]
    assert counts.train_flops_per_image(spec) == counts.flops_per_sample(spec) == 6.0 * want["macs"]
    assert counts.parameters(spec) == want["parameters"]
    leaves = [[p, list(s), b] for p, s, b in ref_model.leaves(spec)]
    assert len(leaves) == want["leaves"]
    assert hashlib.sha256(json.dumps(leaves).encode()).hexdigest() == want["digest"]
    for mix, (dw_ms, encode_ms) in want["least"].items():
        traffic = manifest.traffic(mix)
        assert counts.per_user_dw_least_ms(spec, traffic) == dw_ms
        assert counts.hsq_encode_least_ms(spec, traffic) == encode_ms


def test_a_family_of_the_data_directory_comes_first(tiny):
    fcn = manifest.family("fcn")
    assert os.path.dirname(fcn.__file__) == os.path.join(TESTS, "data", "families")
    resnet = manifest.family("resnet")
    assert os.path.dirname(resnet.__file__) == os.path.join(manifest.BENCH_DIR, "families")
    with pytest.raises(LookupError, match="no family 'mlp'"):
        manifest.family("mlp")


def _imports(path):
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _family_sources():
    for d in FAMILY_DIRS:
        for f in sorted(os.listdir(d)):
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", [p for p in _family_sources() if not p.endswith("_program.py")],
                         ids=lambda p: os.path.relpath(p, manifest.BENCH_DIR))
def test_the_reference_half_of_a_family_imports_nothing_of_the_program(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & FORBIDDEN, tops & FORBIDDEN


@pytest.mark.parametrize("name", ["resnet", "vgg", "fcn"])
def test_a_familys_program_half_is_a_program_file(tiny, name):
    program = manifest.family(manifest.family(name).PROGRAM)
    assert program.__file__.endswith("_program.py")
    for attr in ("config_fields", "build", "leaf_paths", "running_buffers"):
        assert callable(getattr(program, attr))


NAMES = re.compile(r"resnet|vgg|BatchNorm_0|image_shape", re.IGNORECASE)


@pytest.mark.parametrize("sub", ["harness", "reference", "metrics"])
def test_no_harness_module_names_a_family(sub):
    """Everything of a model family is in its module: the harness, the
    reference and the readers name none of them, nor their leaves' paths
    or their data's shape."""
    for d, _, files in os.walk(os.path.join(manifest.BENCH_DIR, sub)):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(d, f)
                hits = [(n, line.strip()) for n, line in enumerate(open(path), 1)
                        if NAMES.search(line)]
                assert not hits, (path, hits)
