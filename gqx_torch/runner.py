"""End-to-end training loop (counterpart of ``gqx/runner.py``; the
reference's ``main`` + ``train`` drivers, its main.py:79-213).

Log cadence parity: evaluate ``log_epoch`` times per epoch and emit
``loss`` / ``accuracy(%)`` at global step iteration*(epoch-1)+batch_idx
(reference main.py:183,197-211).

Batches come from the ``Pipeline`` (gqx's augment rule: the native library
where it builds; the one taken is printed once) in gqx's NHWC layout and go to
the step's (U, B, C, H, W) on the device by a copy and a permute.  The
model's initial weights are drawn from ``config.seed``, the step's
stochastic rounding from a generator seeded with ``config.seed + 17`` (as
gqx seeds its step key).

With ``backend="mesh"`` (an open process group: ``gqx_torch.cli`` opens
it) every rank draws the same global batch and steps on its own users'
rows (``parallel.distributed.local_user_batch``); only rank 0 prints, logs
and profiles (gqx/runner.py:72-100); every rank evaluates and takes part in
checkpoints, which rank 0 writes.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from gqx_torch import resolve_device
from gqx_torch.checkpoint import latest_checkpoint, restore_checkpoint, save_checkpoint
from gqx_torch.config import GQConfig, lr_at_epoch, resolve_schedule, wd_at_epoch
from gqx_torch.data import Pipeline
from gqx_torch.metrics import MetricLogger
from gqx_torch.models import create_model
from gqx_torch.parallel.distributed import local_user_batch, rank_and_world
from gqx_torch.train import create_train_state, evaluate, make_eval_step, make_train_step


def to_device(x: np.ndarray, y: np.ndarray, device: torch.device):
    """A Pipeline batch (..., H, W, C) float32 / int32 labels -> (..., C, H,
    W) float32 / int64 labels on ``device``."""
    xt = torch.from_numpy(x).to(device).movedim(-1, -3).contiguous()
    return xt, torch.from_numpy(y).to(device, torch.int64)


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_training(
    config: GQConfig,
    epochs_override: Optional[int] = None,
    max_steps: Optional[int] = None,
    progress: bool = True,
    resume: bool = False,
    device="cuda",
):
    """Train per the reference schedules on ``device``; returns (state,
    final_accuracy).

    With ``resume=True`` and a checkpoint in ``config.logdir``, training
    restarts from the epoch after the checkpointed one with full state
    (parameters, BN statistics, momentum, EF)."""
    config.validate()
    dev = resolve_device(device)
    rank, world = rank_and_world()
    if config.backend == "mesh" and not torch.distributed.is_initialized():
        raise ValueError("backend='mesh' needs an open process group "
                         "(gqx_torch.parallel.distributed.maybe_initialize)")
    is_main = rank == 0
    progress = progress and is_main
    epochs, base_lr, boundaries, lrs, _, initial_wd = resolve_schedule(config)
    if epochs_override is not None:
        epochs = epochs_override
    else:
        # reference quirk: the epoch loop is range(1, epochs + 2)
        # (reference main.py:159) — one extra epoch beyond the schedule table
        epochs = epochs + 1

    pipeline = Pipeline(config)
    if progress:
        print(f"augment: {pipeline.augment}")
    model = create_model(config.network, config.num_classes, config.compute_dtype,
                         torch.Generator().manual_seed(config.seed),
                         image_shape=pipeline.image_shape)
    state, plan = create_train_state(config, model, device=dev)

    start_epoch = 1
    if resume and config.logdir:
        ckpt = latest_checkpoint(config.logdir)
        if ckpt is not None:
            restore_checkpoint(ckpt, state)
            start_epoch = 1 + state.step // max(1, pipeline.steps_per_epoch)
            if progress:
                print(f"resumed from {ckpt} at epoch {start_epoch}")

    train_step = make_train_step(config, plan)
    eval_step = make_eval_step(state.model)
    logger = MetricLogger(config.logdir if is_main else None)

    def local_batch(x, y):
        """This rank's users of a global batch (all of them under sim)."""
        if config.backend != "mesh":
            return x, y
        return local_user_batch(x, rank, world), local_user_batch(y, rank, world)

    # bytes-on-wire accounting (packed payload sizes), as gqx logs it
    total_params = sum(p.numel() for p in state.model.parameters())
    wire = plan.wire_bytes()
    logger.scalars(
        {"wire_bytes_per_user_step": wire,
         "compression_ratio_vs_fp32": (4.0 * total_params) / max(wire, 1)},
        0,
    )
    if progress:
        print(f"wire: {wire/1e6:.3f} MB/user/step "
              f"({4.0*total_params/max(wire,1):.1f}x vs fp32)")

    generator = torch.Generator().manual_seed(config.seed + 17)

    def test_batches():
        for x, y in pipeline.test_batches(limit=config.eval_batch_count):
            yield to_device(x, y, dev)

    iteration = pipeline.steps_per_epoch
    accuracy = 0.0
    total_steps = 0
    # torch.profiler trace of steady-state steps from step 2 (step 1 builds
    # and loads the kernels)
    profile_at = 2 if config.profile_dir and is_main else None
    profiler = None
    # host seconds in the training loop (batches, transfers, steps), evals
    # and checkpoints excluded; the clock stops after a synchronise
    loop_s = 0.0
    t_start = time.time()

    for epoch in range(start_epoch, epochs + 1):
        lr = lr_at_epoch(epoch, base_lr, boundaries, lrs)
        wd = wd_at_epoch(epoch, initial_wd, boundaries)
        scale = config.ef_scale(epoch)
        log_points = {
            iteration // config.log_epoch * (i + 1) for i in range(config.log_epoch)
        }
        t_loop = time.perf_counter()
        for batch_idx, (x, y) in enumerate(pipeline.train_epoch(epoch)):
            if profile_at is not None and total_steps + 1 == profile_at:
                _synchronize(dev)
                profiler = _start_profile(config.profile_dir, dev)
            xt, yt = to_device(*local_batch(x, y), dev)
            loss = train_step(state, xt, yt, lr, wd, generator, scale)
            total_steps += 1
            if profiler is not None and total_steps >= profile_at + config.profile_steps - 1:
                _synchronize(dev)
                profiler.stop()
                profiler, profile_at = None, None
                if progress:
                    print(f"torch.profiler trace written to {config.profile_dir}")
            if (batch_idx + 1) in log_points:
                loss_value = float(loss)
                loop_s += time.perf_counter() - t_loop
                _, accuracy = evaluate(eval_step, test_batches())
                step = iteration * (epoch - 1) + batch_idx
                logger.scalars({"loss": loss_value, "accuracy(%)": accuracy * 100.0}, step)
                if progress:
                    print(
                        f"Train Epoch: {epoch} [{(batch_idx+1)*config.batch_size*config.num_users}/"
                        f"{pipeline.steps_per_epoch*config.batch_size*config.num_users}]\t"
                        f"Loss: {loss_value:.6f}\t Test Accuracy: {accuracy*100:.2f}%"
                    )
                t_loop = time.perf_counter()
            if max_steps is not None and total_steps >= max_steps:
                break
        _synchronize(dev)
        loop_s += time.perf_counter() - t_loop
        if config.save_model and config.logdir:
            save_checkpoint(config.logdir, state, step=state.step)
        if max_steps is not None and total_steps >= max_steps:
            break

    if profiler is not None:
        _synchronize(dev)
        profiler.stop()
    if progress:
        dt = time.time() - t_start
        print(f"done: {total_steps} steps in {dt:.1f}s ({total_steps/max(dt,1e-9):.2f} steps/s); "
              f"training loop {1e3*loop_s/max(total_steps,1):.2f} ms/step "
              f"(evals and checkpoints excluded)")
    if config.save_model and config.logdir:
        save_checkpoint(config.logdir, state, step=state.step)
    logger.close()
    return state, accuracy


def _start_profile(profile_dir: str, device: torch.device):
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    from gqx_torch.utils.profiling import pad_window

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities, on_trace_ready=tensorboard_trace_handler(profile_dir))
    prof.start()
    if device.type == "cuda":
        # the profiler drops a window's leading device events: spins open it
        pad_window()
    return prof
