"""Checkpoint / resume (counterpart of ``gqx/checkpoint.py``).

The file-name pattern and the "latest by step" rule are gqx's; the payload
is the port's own, written with ``torch.save``: the model's state dict
(parameters and BN running statistics), the momentum trace, the
aggregator's error-feedback state and the step count.  It restores onto
the devices of the state it is loaded into, with ``weights_only=True``.
The port does not read gqx's msgpack checkpoints (flax trees), nor gqx
the port's: carry weights across with ``gqx_torch.convert.from_jax``.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

CKPT_NAME = "gqx_state_{step}.msgpack"


def save_checkpoint(logdir: str, state, step: int) -> str:
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, CKPT_NAME.format(step=step))
    agg = state.agg_state
    torch.save({"model": state.model.state_dict(), "trace": state.trace,
                "ef": agg.ef, "server_ef": agg.server_ef, "step": int(state.step)}, path)
    return path


def latest_checkpoint(logdir: str) -> Optional[str]:
    if not os.path.isdir(logdir):
        return None
    ckpts = [f for f in os.listdir(logdir) if f.startswith("gqx_state_") and f.endswith(".msgpack")]
    if not ckpts:
        return None
    ckpts.sort(key=lambda f: int(f.split("_")[2].split(".")[0]))
    return os.path.join(logdir, ckpts[-1])


@torch.no_grad()
def restore_checkpoint(path: str, target):
    """Restore into ``target``, a TrainState of the same model and plan, in
    place; returns it."""
    dev = next(target.model.parameters()).device
    payload = torch.load(path, map_location=dev, weights_only=True)
    target.model.load_state_dict(payload["model"])
    for name, t in target.trace.items():
        t.copy_(payload["trace"][name])
    agg = target.agg_state
    for mine, saved in ((agg.ef, payload["ef"]), (agg.server_ef, payload["server_ef"])):
        if (mine is None) != (saved is None):
            raise ValueError(f"{path}: error-feedback state does not match the target's")
        for t, s in zip(mine or (), saved or ()):
            t.copy_(s)
    target.step = int(payload["step"])
    return target
