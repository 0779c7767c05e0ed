"""The readers of the program's batch-norm spans: device time launched
inside ``gqx_torch::bn.forward`` (the main thread) and
``gqx_torch::bn.backward`` (the autograd thread), and nothing where the
program has no such span."""

import pytest

from gqbench.harness import manifest, trace

SPEC = manifest.config("resnet50-cifar.bf16")
MIX = manifest.traffic("hsq-d16.ps32x32")


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
            "pid": 1, "args": args}


def _trace(spans=True):
    ev = [_x("kernel", "void at::native::spin_kernel(long)", 0, 50, tid=7, stream=7)]
    corr = iter(range(100, 1000))
    for step in range(3):
        base = 1000 + step * 1000
        ev.append(_x("user_annotation", "gqbench::step", base, 900))
        ev.append(_x("user_annotation", "gqbench::fwd_bwd", base + 100, 500))
        # a batch norm's forward: the benchmark's range, the program's span, a launch
        ev.append(_x("user_annotation", "gqbench::bn_forward", base + 110, 60))
        if spans:
            ev.append(_x("user_annotation", "gqx_torch::bn.forward", base + 115, 50))
        c = next(corr)
        ev.append(_x("cuda_runtime", "cudaLaunchKernel", base + 120, 5, correlation=c))
        ev.append(_x("kernel", "grouped_bn_forward_kernel", base + 200, 30, tid=7, stream=7,
                     correlation=c))
        # a conv outside both
        c = next(corr)
        ev.append(_x("cuda_runtime", "cudaLaunchKernel", base + 180, 5, correlation=c))
        ev.append(_x("kernel", "conv_kernel", base + 240, 60, tid=7, stream=7, correlation=c))
        # the backward node on the autograd thread, the span inside it
        ev.append(_x("cpu_op", "autograd::engine::evaluate_function: "
                     "GroupedBatchNormBackward", base + 300, 50, tid=2))
        if spans:
            ev.append(_x("user_annotation", "gqx_torch::bn.backward", base + 305, 40, tid=2))
        c = next(corr)
        ev.append(_x("cuda_runtime", "cudaLaunchKernel", base + 312, 3, tid=2, correlation=c))
        ev.append(_x("kernel", "grouped_bn_backward_kernel", base + 400, 45, tid=7, stream=7,
                     correlation=c))
    return ev


def _read(spans):
    view = trace.measured(trace.parse(_trace(spans)), SPEC, MIX, {})
    return {name: manifest.reader(name).read(view) for name in
            ("bn_forward_device_ms", "bn_backward_device_ms", "bn_device_ms")}


def test_the_span_readers_split_the_batch_norm_chain():
    read = _read(spans=True)
    assert read["bn_forward_device_ms"] == pytest.approx(0.03)
    assert read["bn_backward_device_ms"] == pytest.approx(0.045)
    assert read["bn_forward_device_ms"] + read["bn_backward_device_ms"] == \
        pytest.approx(read["bn_device_ms"])


def test_the_span_readers_read_nothing_without_the_spans():
    read = _read(spans=False)
    assert read["bn_forward_device_ms"] is None and read["bn_backward_device_ms"] is None
    assert read["bn_device_ms"] == pytest.approx(0.075)


def test_the_span_readers_are_listed_in_every_cell():
    bench = manifest.benchmark()
    for cell in bench["workloads"]:
        names = {m["name"] for m in manifest.per_layer(bench, cell["name"])}
        assert {"bn_forward_device_ms", "bn_backward_device_ms"} <= names
