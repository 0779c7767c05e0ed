"""One run of one cell: set-up, the checked steps, the measured window, the
traced window, then the reference and the verdict.

``run_rank`` is what every rank does; rank 0 also measures, reads the trace,
runs the reference and returns the result.  On one device it is the whole
run; a mix with ``backend: mesh`` starts one process per chip
(``launch``), each a rank of a process group on localhost.
"""

from __future__ import annotations

import contextlib
import datetime
import gc
import importlib
import math
import os
import socket
import statistics
import sys
import tempfile
import time
from typing import Optional

import torch

from gqbench.harness import check, manifest, trace
from gqbench.harness import program
from gqbench.harness.program import Session
from gqbench.reference import model as ref_model
from gqbench.reference import step as ref_step

CHECKED_STEPS = 3
WARM_STEPS = 1
#: host seconds of steady steps the traced window aims at (3 to 10 steps)
TRACE_SECONDS = 2.0
#: how long a rank waits for the others at the rendezvous and at a collective
GROUP_TIMEOUT_S = 300
FORBIDDEN = ("jax", "jaxlib", "flax", "gqx")
#: where a mix's ``plant`` may come from: the tests' planted faults
PLANTS = "gqbench.tests.plants."


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules():
    """Top-level names of loaded modules that the run may not hold, compared
    whole (``gqx_torch`` is not ``gqx``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _open_group(rank: int, world: int, port: int, device: torch.device) -> None:
    import torch.distributed as dist

    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))


def _broadcast(value, world: int):
    if world == 1:
        return value
    import torch.distributed as dist

    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _gather_max(value: int, world: int) -> int:
    if world == 1:
        return value
    import torch.distributed as dist

    out = [None] * world
    dist.all_gather_object(out, value)
    return max(out)


def _plant(mix) -> None:
    """The fault a tests' mix names under ``plant`` (a function of the
    tests' ``plants`` module), planted in this rank."""
    name = mix.get("plant")
    if name is None:
        return
    if not name.startswith(PLANTS):
        raise ValueError(f"plant {name!r}: only {PLANTS}<fault> may be planted")
    module, attr = name.rsplit(".", 1)
    getattr(importlib.import_module(module), attr)()


def run_rank(rank: int, world: int, port: Optional[int], workload: str, seed: int,
             seconds: float, traced: bool, device_type: str, t0: float) -> Optional[dict]:
    bench = manifest.benchmark()
    cell = manifest.workload(bench, workload)
    spec = manifest.config(cell["config"])
    mix = manifest.traffic(cell["traffic"])
    _plant(mix)
    device = torch.device(device_type, rank) if device_type == "cuda" else torch.device("cpu")
    if device.type == "cpu" and world > 1:
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    if world > 1:
        _open_group(rank, world, port, device)
    elif device.type == "cuda":
        torch.cuda.set_device(device)
    parts = {"imports": time.perf_counter() - t0}
    with program.layer_spans() if traced else contextlib.nullcontext():
        return _run(rank, world, cell, bench, spec, mix, seed, seconds, traced, device, t0,
                    parts)


def _run(rank, world, cell, bench, spec, mix, seed, seconds, traced, device, t0, parts):
    session = Session(spec, mix, seed, device, rank, world)
    parts.update(session.parts)
    if rank == 0:
        log(f"[cell] {cell['name']}: {cell['config']} x {cell['traffic']}, {world} rank(s), "
            f"wire {session.plan.wire_bytes()} bytes a user and step, "
            f"augment {session.pipeline.augment}")
    t = time.perf_counter()
    readings = session.checked_steps(CHECKED_STEPS)
    parts["checked_steps"] = time.perf_counter() - t
    t = time.perf_counter()
    for _ in range(WARM_STEPS):
        session.step()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    parts["warm_up"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t0
    steps = None
    if world > 1:
        # every rank must take the same steps: rank 0 fixes their number
        # from the warm-up step's time
        steps = _broadcast(max(3, math.ceil(seconds / max(parts["warm_up"], 1e-3))), world)
    run = session.window(seconds=seconds if steps is None else None, steps=steps)
    parsed = None
    if traced:
        median_ms = statistics.median(run["step_ms"])
        k = _broadcast(min(10, max(3, math.ceil(1e3 * TRACE_SECONDS / median_ms))), world)
        if rank == 0:
            parsed = trace.profile(session, k, tempfile.gettempdir())
        else:
            for _ in range(k + 1):
                session.step()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    peak = _gather_max(int(peak), world)
    del session
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
    if world > 1:
        import torch.distributed as dist

        dist.destroy_process_group()
    if rank != 0:
        return None
    return dict(spec=spec, mix=mix, cell=cell, bench=bench, readings=readings, run=run,
                parsed=parsed, peak=peak, setup_s=setup_s, parts=parts, device=device,
                world=world)


def reference(spec, mix, seed: int, device, data=None, **kw) -> dict:
    """The reference's readings of the checked steps (``kw`` as
    ``reference.step.run`` takes them)."""
    data = ref_step.training_data(spec, mix["data"], seed) if data is None else data
    return ref_step.run(spec, mix, seed, data, manifest.ROOT, device, CHECKED_STEPS, **kw)


def verdict(readings: dict, ref: dict, spec, workload: str) -> dict:
    """The compared numbers of ``readings`` against the reference's, each
    beside its limit; the leaf families and running statistics are the
    model family's."""
    values = check.numbers(readings, ref, ref_model.leaf_families(spec),
                           ref_model.family(spec).FAMILIES, bool(ref_model.running_stats(spec)))
    limits = manifest.limits(workload)
    unmatched = check.unmatched_limits(values, limits)
    if unmatched:
        log(f"[check] the limits of {workload} and the numbers its cell gives differ in "
            f"{unmatched}")
    return check.judge(values, limits)


def per_layer_metrics(view, bench: dict, workload: str):
    """The cell's per-layer metrics read from a traced run, and the names
    of those whose reader found nothing to read."""
    metrics, missing = {}, []
    for m in manifest.per_layer(bench, workload):
        value = manifest.reader(m["name"]).read(view)
        if value is None:
            missing.append(m["name"])
        else:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics, missing


def finish(r: dict, seed: int) -> dict:
    """Rank 0, after the program's state is freed: the metrics, the
    reference and the verdict; returns the result line's fields."""
    spec, mix, cell, bench, run = r["spec"], r["mix"], r["cell"], r["bench"], r["run"]
    g = mix["num_users"] * mix["batch_size"]
    window_ms = sum(run["step_ms"])
    samples_per_s = run["steps"] * g / (window_ms / 1e3)
    run["samples_per_s"] = samples_per_s
    measured = {
        "samples_per_s": samples_per_s,
        "step_ms_p90": (statistics.quantiles(run["step_ms"], n=10, method="inclusive")[8]
                        if run["steps"] > 1 else run["step_ms"][0]),
        "setup_s": r["setup_s"],
    }
    log(f"[setup] {r['setup_s']:.3f} s: " + ", ".join(f"{k} {v:.3f}" for k, v in r["parts"].items()))
    log(f"[window] {run['steps']} steps, {window_ms / 1e3:.3f} s on the stream, "
        f"{samples_per_s:.4f} samples/s, host ms a step: next batch {run['data_ms']:.3f}, "
        f"copy to the device {run['copy_ms']:.3f}")
    metrics, breakdown, device_extra, missing = {}, None, {}, None
    if r["parsed"] is None:
        for m in manifest.end_to_end(bench, cell["name"]):
            metrics[m["name"]] = {"value": measured[m["name"]], "unit": m["unit"]}
    else:
        view = trace.measured(r["parsed"], spec, mix, run)
        metrics, missing = per_layer_metrics(view, bench, cell["name"])
        if missing:
            log(f"[trace] nothing to read for {missing}: a range or kernel they read "
                "is gone from the program")
        breakdown = trace.breakdown(view)
        device_extra = {"busy_s": view.busy_us / 1e6, "window_s": view.window_us / 1e6}
        log(f"[trace] {view.steps} steps, window {view.window_us / 1e3:.3f} ms, busy "
            f"{view.busy_us / 1e3:.3f} ms")
    attempted = run["steps"]
    failed = sum(1 for v in run["losses"] if not math.isfinite(v))

    t = time.perf_counter()
    ref = reference(spec, mix, seed, r["device"])
    judged = verdict(r["readings"], ref, spec, cell["name"])
    if missing is not None:
        # a per-layer metric of the cell that reads nothing fails the run
        judged["metrics_unread"] = {"value": len(missing), "limit": 0}
    log(f"[reference] {time.perf_counter() - t:.3f} s; losses program "
        f"{r['readings']['losses']} reference {ref['losses']}")
    correct = check.passed(judged) and failed == 0
    kind = torch.cuda.get_device_name(r["device"]) if r["device"].type == "cuda" else "cpu"
    device = {"platform": "gpu" if r["device"].type == "cuda" else "cpu", "kind": kind,
              "count": r["world"], "memory_peak_bytes": r["peak"], **device_extra}
    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = judged
    return out


def _rank_main(rank, world, port, workload, seed, seconds, traced, device_type, where):
    manifest.BENCHMARK_FILE, manifest.DATA_DIR = where
    run_rank(rank, world, port, workload, seed, seconds, traced, device_type,
             time.perf_counter())


def launch(workload: str, seed: int, seconds: float, traced: bool, device_type: str,
           t0: float) -> dict:
    """The whole run: one process per rank where the mix asks for several,
    rank 0 in this process; returns rank 0's result."""
    bench = manifest.benchmark()
    mix = manifest.traffic(manifest.workload(bench, workload)["traffic"])
    world = mix["chips"] if mix["backend"] == "mesh" else 1
    port = free_port() if world > 1 else None
    procs = []
    if world > 1:
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        for rank in range(1, world):
            where = (manifest.BENCHMARK_FILE, manifest.DATA_DIR)
            p = ctx.Process(target=_rank_main, args=(rank, world, port, workload, seed,
                                                     seconds, traced, device_type, where))
            p.start()
            procs.append(p)
    try:
        r = run_rank(0, world, port, workload, seed, seconds, traced, device_type, t0)
    finally:
        for p in procs:
            p.join(timeout=600)
            if p.is_alive():
                p.kill()
                p.join()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"a rank exited with {bad}")
    return finish(r, seed)


def environment_ok(chips: int) -> Optional[str]:
    """Why the chip cannot run the cell, or None."""
    if not torch.cuda.is_available():
        return "no CUDA device"
    if torch.cuda.device_count() < chips:
        return f"{torch.cuda.device_count()} CUDA device(s), the cell asks for {chips}"
    return None


def card_line() -> Optional[str]:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().replace("\n", "; ")


def lines(result: dict) -> None:
    """The checks on standard error, last there, then the result line."""
    for name, v in result["checks"].items():
        log(f"check {name}: {v['value']:.6g} limit {v['limit']}")
    print(__import__("json").dumps(result), flush=True)

