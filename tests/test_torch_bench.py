"""gqx_torch.bench on the CPU: its output lines, its wire accounting, its
family classifier, and that it writes no file."""

import ast
import json
import os
import pathlib

import pytest
import torch

from gqx_torch import bench
from gqx_torch.config import GQConfig
from gqx_torch.models import create_model
from gqx_torch.train import create_train_state, make_train_step

REPO = pathlib.Path(__file__).resolve().parents[1]
SHORT = ["--platform", "cpu", "--network", "fcn", "--warmup", "1", "--steps", "2"]


@pytest.fixture(autouse=True)
def few_threads():
    """The suite runs in several worker processes on one host, and torch's
    default of a thread per core in each of them oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _run(capsys, argv):
    details = bench.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    return details, json.loads(lines[-2]), json.loads(lines[-1])


def test_last_line_and_wire_bytes(capsys, tmp_path):
    out = tmp_path / "details.json"
    details, printed, last = _run(capsys, SHORT + ["--quant", "hsq,sgd", "--out", str(out)])
    assert set(last) == {"metric", "value", "unit", "vs_baseline"}
    assert last["unit"] == "steps/s" and last["vs_baseline"] is None
    assert "fcn" in last["metric"] and "hsq(d16,K256,n6)" in last["metric"]
    assert last["metric"].endswith("1 x cpu")
    assert last["value"] == details["configs"]["hsq"]["steps_per_sec"] > 0
    assert printed == json.loads(out.read_text()) == json.loads(json.dumps(details))
    for q, row in details["configs"].items():
        cfg = GQConfig(network="fcn", dataset="synthetic", num_users=8, batch_size=32,
                       compute_dtype="bfloat16", **bench.CANONICAL[q])
        model = create_model("fcn", 10, "bfloat16", image_shape=(32, 32, 3))
        _, plan = create_train_state(cfg, model, device="cpu")
        assert row["wire_bytes_per_user_step"] == plan.wire_bytes()
        params = sum(p.numel() for p in model.parameters())
        assert row["compression_ratio_vs_fp32"] == pytest.approx(4.0 * params / plan.wire_bytes())
        # on the CPU the device figures are not measured
        assert row["device_ms_per_step"] is None and row["device_split_ms"] is None
        assert row["ms_per_step"] > 0


def test_writes_no_file(capsys, tmp_path, monkeypatch):
    watched = [REPO / "BENCH_DETAILS.json", REPO / "BASELINE_MEASURED.json"]
    before = {p: p.stat().st_mtime_ns for p in watched}
    top = sorted(os.listdir(REPO))
    monkeypatch.chdir(tmp_path)
    _run(capsys, SHORT + ["--quant", "sgd"])
    assert os.listdir(tmp_path) == []
    assert {p: p.stat().st_mtime_ns for p in watched} == before
    assert sorted(os.listdir(REPO)) == top


def test_unknown_configuration_raises():
    with pytest.raises(ValueError, match="unknown configurations"):
        bench.main(SHORT + ["--quant", "hsq,nosuch"])


CASES = [
    ("void hsq_encode_tc_kernel<16, 8>(float const*, ...)", ["aten::empty"], "K1 hsq_encode"),
    ("void per_user_dw_tc_f32_kernel<3>(float const*)", [], "K7 per_user_dw_tc_f32"),
    ("void per_user_dw_kernel<64>(float const*)", [], "K7 per_user_dw (CUDA cores)"),
    ("gather_scale_kernel<unsigned char>", ["SharedConvBackward"], "K4/K6 decode"),
    ("void at::native::elementwise_kernel<128, 2>(...)",
     ["aten::mul", "GroupedBatchNormBackward", "autograd::engine::evaluate_function: "
      "GroupedBatchNormBackward"], "BN backward"),
    ("void at::native::elementwise_kernel<128, 2>(...)",
     ["aten::copy_", "aten::_to_copy", "aten::to", bench.BN_FORWARD], "BN forward"),
    ("void multi_tensor_apply_kernel<...>", ["aten::_foreach_mul_"], "SGD update"),
    ("sm90_xmma_fprop_implicit_gemm_bf16", ["aten::cudnn_convolution", "aten::_convolution",
                                            "aten::convolution", "aten::conv2d"], "convolutions"),
    ("sm90_xmma_dgrad", ["aten::convolution_backward", "SharedConvBackward"], "convolutions"),
    ("nvjet_hsh_128x64", ["aten::bmm", "aten::einsum", "SharedConvBackward"], "GEMMs/einsums"),
    ("void at::native::elementwise_kernel<4>(...)",
     ["aten::copy_", "aten::clone", "aten::einsum"], "GEMMs/einsums"),
    ("void at::native::unrolled_elementwise_kernel<direct_copy_kernel_cuda>",
     ["aten::copy_", "aten::_to_copy", "aten::to"], "casts and copies"),
    ("void at::native::vectorized_elementwise_kernel<4, threshold_kernel>",
     ["aten::threshold_backward", "ReluBackward0"], "the rest"),
    ("Memset (Device)", [], bench.UNATTRIBUTED),
]


@pytest.mark.parametrize("kernel,ops,family", CASES)
def test_classify(kernel, ops, family):
    assert bench.classify(kernel, ops) == family


@pytest.mark.parametrize("name,op", [
    ("aten::copy_", True), ("SharedConvBackward", True), (bench.BN_FORWARD, True),
    ("Activity Buffer Request", False), ("Command Buffer Full", False),
    ("cudaLaunchKernel", False), ("cudaOccupancyMaxActiveBlocksPerMultiprocessorWithFlags", False)])
def test_profiler_internal_events_hold_no_kernels_of_the_split(name, op):
    assert bench.is_op(name) == op


def test_profiled_cpu_ops_reach_every_family():
    """A folded ResNet-18 step on the CPU under torch.profiler: each leaf CPU
    op, classified by its chain of CPU-op parents, reaches every family but
    the hand-written kernels (whose CPU versions are plain PyTorch); the BN
    forward family through the program's own range round each batch norm's
    forward, with no hook of the bench's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = GQConfig(network="resnet18", quantizer="sgd", num_users=2, batch_size=2)
    model = create_model("resnet18", 10, generator=torch.Generator().manual_seed(0))
    state, plan = create_train_state(cfg, model, device="cpu")
    step = make_train_step(cfg, plan)
    x = torch.randn(2, 2, 3, 32, 32, generator=torch.Generator().manual_seed(1))
    y = torch.tensor([[1, 2], [3, 4]])
    assert not any(m._forward_hooks or m._forward_pre_hooks for m in model.modules())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, x, y, 0.1, 5e-4, None)
    chains = [bench.op_chain(e) for e in prof.events()
              if e.device_type == DeviceType.CPU and not e.cpu_children]
    found = {bench.classify("", ops) for ops in chains}
    assert set(bench.FAMILIES) <= found
    assert bench.BN_FORWARD == "gqx_torch::bn.forward"


def test_port_imports_not_the_root_bench():
    for f in sorted((REPO / "gqx_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom) and node.level == 0
                     else [])
            assert "bench" not in [n.split(".")[0] for n in names], f
