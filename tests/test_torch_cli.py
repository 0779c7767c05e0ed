"""gqx_torch.cli against gqx.cli: the same parser, the same config, and the
verify skill's FCN drive on the CPU."""

import argparse
import csv
import dataclasses
import os

import pytest
import torch

from gqx.cli import build_parser as gqx_build_parser
from gqx_torch.cli import build_parser, config_from_args, main
from gqx_torch.config import GQConfig

VERIFY = ["--network", "fcn", "--dataset", "synthetic", "--quantizer", "hsq", "--c-dim", "16",
          "--k-bit", "6", "--n-bit", "6", "--num-users", "8", "--batch-size", "16",
          "--epochs", "1"]


@pytest.fixture(autouse=True)
def few_threads():
    """The suite runs in several worker processes on one host, and torch's
    default of a thread per core in each of them oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _options(parser):
    return {tuple(a.option_strings): (a.dest, a.default, a.choices, a.type, a.nargs, a.const,
                                      type(a).__name__)
            for a in parser._actions if not isinstance(a, argparse._HelpAction)}


def test_parser_matches_gqx():
    """Same option strings, destinations, defaults, choices, types and
    actions as gqx's parser."""
    assert _options(build_parser()) == _options(gqx_build_parser())


def test_cli_defaults_match_config_defaults():
    cfg = config_from_args(build_parser().parse_args([]))
    ref = GQConfig()
    mismatches = {f.name: (getattr(cfg, f.name), getattr(ref, f.name))
                  for f in dataclasses.fields(GQConfig)
                  if getattr(cfg, f.name) != getattr(ref, f.name)}
    assert not mismatches, f"CLI defaults diverge from GQConfig: {mismatches}"


def test_cli_flags_reach_config():
    args = build_parser().parse_args(
        ["--hsq-passes", "2", "--folded-users", "0", "--random", "0", "--use-pallas", "1",
         "--quantizer", "qsgd", "--c-dim", "128", "--n-bit", "2", "--epochs", "3",
         "--profile-dir", "p", "--compute-dtype", "bfloat16", "--ef", "--two-phase"])
    cfg = config_from_args(args)
    assert (cfg.hsq_passes, cfg.folded_users, cfg.random, cfg.use_pallas) == (2, False, False, True)
    assert (cfg.quantizer, cfg.c_dim, cfg.n_bit, cfg.epochs) == ("qsgd", 128, 2, 3)
    assert (cfg.profile_dir, cfg.compute_dtype, cfg.ef, cfg.two_phase) == (
        "p", "bfloat16", True, True)


# --backend mesh and --wire packed train (the distributed backend); the
# mesh backend lifts no other refusal
@pytest.mark.parametrize("flags", [["--backend", "mesh", "--hsq-passes", "6"],
                                   ["--wire", "packed", "--use-pallas", "0"],
                                   ["--use-pallas", "0"], ["--hsq-passes", "6"],
                                   ["--compute-dtype", "float16"]])
def test_unimplemented_values_raise(flags):
    with pytest.raises(ValueError, match="not implemented by the port"):
        config_from_args(build_parser().parse_args(flags))


# a coordinator without a process count and id, and two processes without
# a coordinator, raise before any rendezvous
@pytest.mark.parametrize("flags", [["--coordinator-address", "localhost:1234"],
                                   ["--num-processes", "2"], ["--platform", "tpu"]])
def test_unimplemented_runtime_flags_raise(flags):
    platform = [] if "--platform" in flags else ["--platform", "cpu"]
    with pytest.raises(ValueError):
        main(VERIFY + platform + flags)


def test_no_platform_flag_means_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(VERIFY)


def test_verify_drive_on_the_cpu(tmp_path, capsys):
    """The verify skill's FCN command: 32 steps, then >= 99% test accuracy
    (gqx reaches 100% with these flags) and a populated scalars.csv."""
    state, accuracy = main(VERIFY + ["--platform", "cpu", "--logdir", str(tmp_path)])
    assert state.step == 32
    assert accuracy >= 0.99
    with open(os.path.join(tmp_path, "scalars.csv")) as f:
        tags = [(r["tag"], int(r["step"])) for r in csv.DictReader(f)]
    assert tags == [("wire_bytes_per_user_step", 0), ("compression_ratio_vs_fp32", 0),
                    ("loss", 31), ("accuracy(%)", 31)]
    out = capsys.readouterr().out
    assert "Test Accuracy:" in out and "done: 32 steps" in out


def test_mesh_packed_verify_drive_on_the_cpu(tmp_path, capsys):
    """The verify drive on the distributed backend with the packed wire, one
    process (a gloo group of one, opened and closed by the CLI): the sim
    backend's accuracy and tags."""
    import torch.distributed as dist

    state, accuracy = main(VERIFY + ["--platform", "cpu", "--backend", "mesh", "--wire",
                                     "packed", "--logdir", str(tmp_path)])
    assert state.step == 32 and accuracy >= 0.99
    assert not dist.is_initialized()
    with open(os.path.join(tmp_path, "scalars.csv")) as f:
        tags = [(r["tag"], int(r["step"])) for r in csv.DictReader(f)]
    assert tags == [("wire_bytes_per_user_step", 0), ("compression_ratio_vs_fp32", 0),
                    ("loss", 31), ("accuracy(%)", 31)]
    assert "done: 32 steps" in capsys.readouterr().out


def test_mesh_without_a_card_raises():
    """No --platform means the card for the distributed backend too: NCCL,
    no fallback to gloo on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(VERIFY + ["--backend", "mesh", "--wire", "packed"])
