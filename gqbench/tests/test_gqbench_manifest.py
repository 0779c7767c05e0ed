"""BENCHMARK.json against the benchmark's contract and its files; what the
benchmark may import."""

import ast
import os
import re

import pytest

from gqbench.harness import check, manifest

BENCH = manifest.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
GQBENCH = manifest.BENCH_DIR
FORBIDDEN = {"jax", "jaxlib", "flax", "gqx"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gqbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(LINE.match(w) for w in BENCH["command"])
    assert os.path.getsize(manifest.BENCHMARK_FILE) <= 64 * 1024


def test_names_and_units_use_allowed_characters():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert LINE.match(c["source"]) and LINE.match(c["why"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4) and LINE.match(w["why"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for item in BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(item["name"]), item["name"]
    for group in ("configs", "workloads"):
        ns = [x["name"] for x in BENCH[group]]
        assert len(ns) == len(set(ns))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_every_cell_has_its_files():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        c = configs[w["config"]]
        spec = manifest.config(w["config"])
        assert os.path.join(manifest.ROOT, c["file"]) == os.path.join(
            GQBENCH, "configs", f"{w['config']}.json")
        assert spec["reduced"] == c["reduced"]
        mix = manifest.traffic(w["traffic"])
        assert mix["chips"] == w["chips"]
        limits = manifest.limits(w["name"])
        assert set(limits) == set(check.NUMBERS)


def test_configs_hold_the_published_parameter_counts():
    from gqbench.harness import counts

    for c in BENCH["configs"]:
        spec = manifest.config(c["name"])
        assert counts.parameters(spec) == spec["num_parameters"]


def test_each_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in manifest.end_to_end(BENCH, w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert manifest.per_layer(BENCH, w["name"])


def test_each_per_layer_metric_moves_a_metric_its_cells_report():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", [w["name"] for w in BENCH["workloads"]]):
            assert m["moves"] in {x["name"] for x in manifest.end_to_end(BENCH, cell)}


def test_each_per_layer_metric_has_a_reader_that_agrees():
    layers = {}
    for m in BENCH["per_layer"]:
        mod = manifest.reader(m["name"])
        assert (mod.UNIT, mod.LAYER, mod.MOVES) == (m["unit"], m["layer"], m["moves"])
        assert callable(mod.read)
        assert LINE.match(m["layer"])
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert "per-user forward and backward" in layers


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" \
                and node.args and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(GQBENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, GQBENCH))
def test_no_module_imports_jax_or_the_jax_package(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & FORBIDDEN, tops & FORBIDDEN


@pytest.mark.parametrize("path", sorted(_sources("reference")),
                         ids=lambda p: os.path.relpath(p, GQBENCH))
def test_the_reference_imports_nothing_of_the_program(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert "gqx_torch" not in tops and not tops & FORBIDDEN


def test_file_names_are_made_of_name_characters():
    for d, _, files in os.walk(GQBENCH):
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), manifest.ROOT)
            if "__pycache__" in rel:
                continue
            assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", rel), rel
