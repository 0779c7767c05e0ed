"""One rank of a multi-process run of the distributed backend on the CPU
(gloo): the counterpart of gqx's ``tests/multihost_child.py``, importing no
jax.

    python -m gqx_torch.scripts.dist_worker JOBS RANK WORLD STORE OUT

``JOBS`` is a JSON file; ``STORE`` a file path for the gloo rendezvous (a
``FileStore``, no port); results go to ``OUT/<job>.<rank>.pt``.  Every job
trains the same model from the same weights and batches with
``backend="mesh"``, each rank on its own users' rows of the global batch:

    {"jobs": [{"name": str, "config": {GQConfig fields}, "weights": path,
               "batches": path (x (S, U, B, C, H, W), y (S, U, B)),
               "steps": int, "seed": int, "lr": float, "wd": float,
               "scale": float,
               "checkpoint_at": step or null (save there, restore into a
                   fresh state, go on),
               "codebook_cache": dir or null (a codebook no file holds is
                   trained into it; the result counts the trainings)}],
     "cli": [argv] or null, "cli_store": path}

A job's result holds its losses, state dict, momentum, this rank's EF and
the server EF.  After the jobs the group is closed and, with "cli", the
rank runs ``gqx_torch.cli.main(argv + the multi-process flags)`` with the
rendezvous ``file://cli_store`` and saves its step and accuracy.
"""

from __future__ import annotations

import json
import os
import sys

import torch
import torch.distributed as dist


def _run_job(job, rank: int, world: int, out_dir: str):
    from gqx_torch import codebooks
    from gqx_torch.checkpoint import latest_checkpoint, restore_checkpoint, save_checkpoint
    from gqx_torch.codebooks import kmeans
    from gqx_torch.config import GQConfig
    from gqx_torch.models import create_model
    from gqx_torch.parallel.distributed import process_user_range
    from gqx_torch.train import create_train_state, make_train_step

    trained = []
    if job.get("codebook_cache"):
        codebooks.CACHE_DIR = job["codebook_cache"]
        codebooks.get_codebook.cache_clear()
        inner = kmeans.train_codebook

        def counted(*args, **kwargs):
            trained.append(args[:2])
            return inner(*args, **kwargs)

        codebooks.train_codebook = counted
    cfg = GQConfig(**job["config"])

    def build(seed):
        model = create_model(cfg.network, cfg.num_classes, cfg.compute_dtype,
                             torch.Generator().manual_seed(seed))
        if job.get("weights"):
            model.load_state_dict(torch.load(job["weights"], weights_only=True))
        state, plan = create_train_state(cfg, model, device="cpu")
        return state, plan

    state, plan = build(0)
    step = make_train_step(cfg, plan)
    batches = torch.load(job["batches"], weights_only=True)
    first, stop = process_user_range(cfg.num_users, rank, world)
    gen = torch.Generator().manual_seed(job["seed"])
    logdir = os.path.join(out_dir, f"{job['name']}_checkpoints")
    losses = []
    for s in range(job["steps"]):
        if s == job.get("checkpoint_at"):
            save_checkpoint(logdir, state, state.step)
            # a fresh state from other weights: the restore must bring all back
            state, plan = build(1)
            restore_checkpoint(latest_checkpoint(logdir), state)
        x, y = batches["x"][s][first:stop], batches["y"][s][first:stop]
        losses.append(float(step(state, x, y, job["lr"], job["wd"], gen, job["scale"])))
    agg = state.agg_state
    out = {"losses": losses, "state_dict": state.model.state_dict(), "trace": state.trace,
           "ef": agg.ef, "server_ef": agg.server_ef, "users": [first, stop],
           "trained": len(trained)}
    if job.get("codebook_cache"):
        comp = next(u.compressor for u in plan.units if hasattr(u.compressor, "file_codebook"))
        out["codebook"] = torch.from_numpy(comp.file_codebook)
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    jobs_path, rank, world, store, out_dir = argv[0], int(argv[1]), int(argv[2]), argv[3], argv[4]
    torch.set_num_threads(1)
    from gqx_torch.parallel.distributed import maybe_initialize

    with open(jobs_path) as f:
        spec = json.load(f)
    maybe_initialize(f"file://{store}", world, rank, device="cpu")
    try:
        for job in spec["jobs"]:
            result = _run_job(job, rank, world, out_dir)
            torch.save(result, os.path.join(out_dir, f"{job['name']}.{rank}.pt"))
    finally:
        dist.destroy_process_group()
    if spec.get("cli"):
        from gqx_torch import cli

        state, accuracy = cli.main(spec["cli"] + [
            "--coordinator-address", f"file://{spec['cli_store']}", "--num-processes",
            str(world), "--process-id", str(rank)])
        torch.save({"step": state.step, "accuracy": accuracy},
                   os.path.join(out_dir, f"cli.{rank}.pt"))


if __name__ == "__main__":
    main()
