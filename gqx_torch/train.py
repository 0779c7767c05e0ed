"""Training step (counterpart of ``gqx/train.py``).

One step, as the reference's ``one_iter`` (its main.py:216-233) runs it:
per-user forward/backward on each user's micro-batch, the users' gradients
packed into compression units, PS or chain-ring aggregation (HSQ encode,
norm quantization, decode; optionally error feedback and the two-phase
downlink), then SGD with momentum and weight decay applied to the
aggregated gradient.  The per-user gradients come from a
loop over users, one forward/backward each; gqx's folded-users trick is a
faster route to the same values and is not ported yet.

The step updates the model, the momentum trace, the aggregator's
error-feedback state and the BN running statistics in place.

Optimizer parity: torch ``optim.SGD(lr, momentum, weight_decay)`` ==
t' = (g + wd*p) + momentum*t; p' = p - lr*t' (``fused_sgd_update``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from gqx_torch import resolve_device
from gqx_torch.config import resolve_schedule
from gqx_torch.convert import leaf_paths
from gqx_torch.models.common import clear_batch_stats, update_running_stats
from gqx_torch.parallel.aggregate import AggState, init_state, make_aggregator
from gqx_torch.parallel.packing import UnitPlan, plan_units


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    trace: Dict[str, torch.Tensor]   # momentum trace per parameter name
    agg_state: AggState = dataclasses.field(default_factory=AggState)
    step: int = 0


def create_train_state(config, model: nn.Module, device="cuda") -> Tuple[TrainState, UnitPlan]:
    """Move ``model`` to ``device``, build the compression unit plan (in
    gqx's leaf order), zero momentum and zero error-feedback state.  Returns
    (state, plan).

    On a CUDA device with float32 compute, TF32 is switched off for cuDNN
    convolutions and cuBLAS matmuls (process-wide flags), so float32 means
    float32 as it does in gqx."""
    config.validate()
    dev = resolve_device(device)
    if dev.type == "cuda" and config.compute_dtype == "float32":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    model.to(dev).train()
    params = dict(model.named_parameters())
    plan = plan_units([(n, tuple(p.shape)) for n, p in params.items()],
                      leaf_paths(model), config)
    trace = {n: torch.zeros_like(p) for n, p in params.items()}
    agg_state = init_state(plan, config.num_users, config.ef, config.two_phase, dev)
    return TrainState(model, trace, agg_state), plan


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits, labels)


@torch.no_grad()
def fused_sgd_update(agg_grads: Dict[str, torch.Tensor],
                     params: Dict[str, torch.Tensor],
                     trace: Dict[str, torch.Tensor],
                     lr: float, wd: float, momentum: float) -> None:
    """In place: t = (g + wd*p) + momentum*t; p = p - lr*t, in that op order
    (gqx/train.py:72-90), over all leaves at once with multi-tensor ops."""
    names = list(params)
    p = [params[n] for n in names]
    g = [agg_grads[n] for n in names]
    t = [trace[n] for n in names]
    t2 = torch._foreach_mul(p, wd)
    torch._foreach_add_(t2, g)
    torch._foreach_add_(t2, torch._foreach_mul(t, momentum))
    torch._foreach_copy_(t, t2)
    torch._foreach_sub_(p, torch._foreach_mul(t2, lr))


def user_grads(model: nn.Module, names, x: torch.Tensor, y: torch.Tensor):
    """Per-user losses (U,) and gradients {name: (U, *shape)} from one
    forward/backward per user micro-batch; each BatchNorm records each
    user's batch statistics."""
    params = dict(model.named_parameters())
    leaves = [params[n] for n in names]
    users = x.shape[0]
    grads = {n: torch.empty((users,) + tuple(p.shape), dtype=torch.float32,
                            device=p.device) for n, p in zip(names, leaves)}
    losses = []
    for i in range(users):
        loss = cross_entropy(model(x[i]), y[i])
        for n, g in zip(names, torch.autograd.grad(loss, leaves)):
            grads[n][i] = g
        losses.append(loss.detach())
    return torch.stack(losses), grads


def make_train_step(config, plan: UnitPlan) -> Callable:
    """step(state, x (U, B, C, H, W), y (U, B), lr, wd, generator, scale=1.0)
    -> mean loss.  ``generator`` (a CPU ``torch.Generator``) seeds the norm
    quantizer's stochastic rounding; it may be None with ``random=False``.
    ``scale`` multiplies the error-feedback error before it is added to the
    gradient (``config.ef_scale(epoch)``); it is unused without EF."""
    aggregator = make_aggregator(config, plan)
    momentum = resolve_schedule(config)[4]

    def train_step(state: TrainState, x, y, lr: float, wd: float,
                   generator: Optional[torch.Generator], scale: float = 1.0):
        model = state.model
        dev = next(model.parameters()).device
        if x.device != dev or y.device != dev:
            raise ValueError(f"batch on {x.device}/{y.device}, model on {dev}")
        clear_batch_stats(model)
        losses, grads = user_grads(model, plan.names, x, y)
        agg = aggregator(grads, state.agg_state, scale, generator)
        fused_sgd_update(agg, dict(model.named_parameters()), state.trace,
                         lr, wd, momentum)
        update_running_stats(model)
        state.step += 1
        return losses.mean()

    return train_step
