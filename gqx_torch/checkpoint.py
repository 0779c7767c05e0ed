"""Checkpoint / resume (counterpart of ``gqx/checkpoint.py``).

The file-name pattern and the "latest by step" rule are gqx's; the payload
is the port's own, written with ``torch.save``: the model's state dict
(parameters and BN running statistics), the momentum trace, the
aggregator's error-feedback state and the step count.  It restores onto
the devices of the state it is loaded into, with ``weights_only=True``.
The port does not read gqx's msgpack checkpoints (flax trees), nor gqx
the port's: carry weights across with ``gqx_torch.convert.from_jax``.

With several processes (``gqx_torch.parallel.collectives``) every rank
calls both functions.  ``save_checkpoint`` gathers each unit's per-user
error feedback of every rank to rank 0 (rank-major rows: the users in
order, or the segmented ring's (W, W, chunk) slots), rank 0 alone writes,
and a barrier follows; ``restore_checkpoint`` gives each rank its own rows.
gqx writes from every process to one path (gqx/checkpoint.py:24).  A saved
state whose unit count or buffer shapes differ from the target's raises
``ValueError`` naming the unit, where gqx's segmented-ring resume zeroes
such buffers silently (gqx/parallel/collectives.py:316-328).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from gqx_torch.parallel.distributed import rank_and_world

CKPT_NAME = "gqx_state_{step}.msgpack"


def _gather_rows(t: torch.Tensor, rank: int, world: int):
    """Rank 0: every rank's rows of ``t`` stacked rank-major; else None."""
    if world == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(world)] if rank == 0 else None
    dist.gather(t.contiguous(), parts, dst=0)
    return torch.cat(parts) if rank == 0 else None


def save_checkpoint(logdir: str, state, step: int) -> str:
    """Write ``state`` as ``gqx_state_<step>.msgpack`` in ``logdir`` (rank 0
    alone, after the error feedback of every rank is gathered to it; every
    rank calls it).  Returns the path."""
    rank, world = rank_and_world()
    path = os.path.join(logdir, CKPT_NAME.format(step=step))
    agg = state.agg_state
    ef = None if agg.ef is None else [_gather_rows(e, rank, world) for e in agg.ef]
    if rank == 0:
        os.makedirs(logdir, exist_ok=True)
        torch.save({"model": state.model.state_dict(), "trace": state.trace,
                    "ef": ef, "server_ef": agg.server_ef, "step": int(state.step)}, path)
    if world > 1:
        dist.barrier()
    return path


def latest_checkpoint(logdir: str) -> Optional[str]:
    if not os.path.isdir(logdir):
        return None
    ckpts = [f for f in os.listdir(logdir) if f.startswith("gqx_state_") and f.endswith(".msgpack")]
    if not ckpts:
        return None
    ckpts.sort(key=lambda f: int(f.split("_")[2].split(".")[0]))
    return os.path.join(logdir, ckpts[-1])


def _check_units(path: str, what: str, mine, saved, world: int) -> None:
    """Raise unless ``saved`` holds, unit for unit, ``world`` ranks' rows of
    each of ``mine``'s buffers."""
    if (mine is None) != (saved is None):
        raise ValueError(f"{path}: {what} state does not match the target's")
    if mine is None:
        return
    if len(mine) != len(saved):
        raise ValueError(f"{path}: {what} state of {len(saved)} units, the target has "
                         f"{len(mine)}")
    for ui, (t, s) in enumerate(zip(mine, saved)):
        want = (world * t.shape[0],) + tuple(t.shape[1:]) if t.dim() else ()
        if tuple(s.shape) != want:
            raise ValueError(f"{path}: {what} of unit {ui} has shape {tuple(s.shape)}, the "
                             f"target needs {want}")


@torch.no_grad()
def restore_checkpoint(path: str, target):
    """Restore into ``target``, a TrainState of the same model and plan, in
    place; returns it.  Each rank takes its own rows of the per-user error
    feedback; the server error feedback is replicated."""
    rank, world = rank_and_world()
    payload = torch.load(path, map_location="cpu", weights_only=True)
    agg = target.agg_state
    _check_units(path, "error-feedback", agg.ef, payload["ef"], world)
    _check_units(path, "server error-feedback", agg.server_ef, payload["server_ef"], 1)
    target.model.load_state_dict(payload["model"])
    for name, t in target.trace.items():
        t.copy_(payload["trace"][name])
    for t, s in zip(agg.ef or (), payload["ef"] or ()):
        n = t.shape[0]
        t.copy_(s[rank * n:(rank + 1) * n])
    for t, s in zip(agg.server_ef or (), payload["server_ef"] or ()):
        t.copy_(s)
    target.step = int(payload["step"])
    return target
