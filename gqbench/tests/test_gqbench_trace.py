"""Reading a profiled window: device events tied to their launches' ranges
and ops, a launch the trace lacks, the spins, the idle share, the readers."""

import pytest

from gqbench.harness import cell, manifest, program, trace

SPEC = manifest.config("resnet50-cifar.bf16")
MIX = manifest.traffic("hsq-d16.ps32x32")


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
            "pid": 1, "args": args}


def _trace():
    ev = [_x("kernel", "void at::native::spin_kernel(long)", 0, 50, tid=7, stream=7)]
    corr = iter(range(100, 1000))
    for step in range(3):
        base = 1000 + step * 1000
        ev.append(_x("user_annotation", "gqbench::step", base, 900))
        ev.append(_x("user_annotation", "gqbench::fwd_bwd", base + 100, 500))
        ev.append(_x("cpu_op", "aten::mul", base + 150, 20))
        c = next(corr)
        ev.append(_x("cuda_runtime", "cudaLaunchKernel", base + 160, 5, correlation=c))
        ev.append(_x("kernel", "elementwise_kernel", base + 200, 100, tid=7, stream=7,
                     correlation=c))
        # the backward, launched from the autograd thread under the main
        # thread's range
        ev.append(_x("cpu_op", "autograd::engine::evaluate_function: "
                     "GroupedBatchNormBackward", base + 300, 50, tid=2))
        ev.append(_x("cpu_op", "aten::sub", base + 310, 10, tid=2))
        c = next(corr)
        ev.append(_x("cuda_runtime", "cudaLaunchKernel", base + 312, 3, tid=2, correlation=c))
        ev.append(_x("kernel", "bn_kernel", base + 400, 200, tid=7, stream=7, correlation=c))
        # a hand-written kernel whose launch the trace does not hold
        ev.append(_x("kernel", "per_user_dw_tc_kernel<64>", base + 600, 100, tid=7, stream=7,
                     correlation=99999))
        ev.append(_x("user_annotation", "gqbench::aggregate", base + 650, 100))
        c = next(corr)
        ev.append(_x("cuda_runtime", "cudaLaunchKernel", base + 660, 5, correlation=c))
        ev.append(_x("kernel", "hsq_encode_tc_kernel", base + 760, 40, tid=7, stream=7,
                     correlation=c))
    return ev


def test_parse_ties_events_to_ranges_and_steps():
    parsed = trace.parse(_trace())
    assert parsed["pads"] == 1 and parsed["steps"] == 3
    ev = parsed["events"]
    assert len(ev) == 12
    first = ev[:4]
    assert [e["span"] for e in first] == ["gqbench::fwd_bwd"] * 3 + ["gqbench::aggregate"]
    assert first[0]["ops"][0] == "aten::mul" and first[0]["family"] == "the rest"
    assert first[1]["family"] == "BN backward"
    # no launch in the trace: the range and ops of the event before it
    assert first[2]["family"] == "K7 per_user_dw_tc" and first[2]["step"] == 0
    assert first[3]["family"] == "K1 hsq_encode"


def test_view_and_readers():
    run = {"samples_per_s": 3000.0, "data_ms": 12.5}
    view = trace.measured(trace.parse(_trace()), SPEC, MIX, run)
    assert view.steps == 2
    # the measured window: from step 1's first event to step 2's last
    assert view.window_us == pytest.approx(2800 - 1200)
    assert view.busy_us == pytest.approx(2 * 440)
    read = {m["name"]: manifest.reader(m["name"]).read(view)
            for m in manifest.benchmark()["per_layer"]}
    assert read["fwd_bwd_device_ms"] == pytest.approx(0.4)
    assert read["aggregate_device_ms"] == pytest.approx(0.04)
    assert read["bn_device_ms"] == pytest.approx(0.2)
    assert read["data_wait_ms"] == 12.5
    assert read["device_idle_share"] == pytest.approx(100 * (1 - 880 / 1600))
    assert read["per_user_dw_roofline"] > 0 and read["hsq_encode_roofline"] > 0
    assert read["step_mfu"] == pytest.approx(2.3620, abs=1e-4)
    out = trace.breakdown(view)
    assert set(out) == {"device_ops", "idle_gaps"}
    assert out["device_ops"][0][0] == "BN_backward:aten::sub"
    assert all(len(row) == 2 for row in out["idle_gaps"])


def test_a_reader_that_finds_nothing_returns_none():
    view = trace.View([], 1, 1.0, 1.0, SPEC, MIX, {})
    for name in ("fwd_bwd_device_ms", "per_user_dw_roofline", "hsq_encode_roofline",
                 "step_mfu", "bn_device_ms", "aggregate_device_ms"):
        assert manifest.reader(name).read(view) is None


def test_a_metric_that_reads_nothing_is_named():
    view = trace.View([], 1, 1.0, 1.0, SPEC, MIX, {})
    bench = manifest.benchmark()
    metrics, missing = cell.per_layer_metrics(view, bench, "resnet50.hsq.u32")
    listed = [m["name"] for m in manifest.per_layer(bench, "resnet50.hsq.u32")]
    assert sorted(missing + list(metrics)) == sorted(listed)
    assert {"fwd_bwd_device_ms", "per_user_dw_roofline", "step_mfu"} <= set(missing)


def test_a_range_round_a_call_the_program_lacks_stops_the_run(monkeypatch):
    monkeypatch.setattr(program, "SPANS", program.SPANS + (
        ("gqx_torch.train", "a_call_renamed_away", "gqbench::fwd_bwd"),))
    with pytest.raises(LookupError, match="a_call_renamed_away"):
        with program.layer_spans():
            pass
    import gqx_torch.train

    # no range was left round a call
    assert gqx_torch.train.folded_user_grads.__module__.startswith("gqx_torch")
