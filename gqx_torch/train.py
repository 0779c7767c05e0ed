"""Training step (counterpart of ``gqx/train.py``).

One step, as the reference's ``one_iter`` (its main.py:216-233) runs it:
each user's gradient on its own micro-batch, the users' gradients packed
into compression units, PS or chain-ring aggregation (the configured
compressor's encode and decode; optionally error feedback and the two-phase
downlink), then SGD with momentum and weight decay applied to the
aggregated gradient.

The per-user gradients come by one of two routes.  With
``config.folded_users`` (the default, gqx's canonical step) one forward and
one data-gradient backward run on the folded (U*B) batch and only the
weight gradients are kept apart per user (``folded_user_grads``,
``gqx_torch.models.folded``); on a CUDA device the per-user weight gradient
of every stride-1 same-size KxK conv is the hand-written kernel of
``gqx_torch.ops.dw``, on the CPU its plain version.  With
``folded_users=False`` a loop over the users runs one forward/backward each
(``user_grads``, gqx's vmap route).

``make_eval_step`` / ``evaluate`` are the test-set evaluation.

The step updates the model, the momentum trace, the aggregator's
error-feedback state and the BN running statistics in place.

Optimizer parity: torch ``optim.SGD(lr, momentum, weight_decay)`` ==
t' = (g + wd*p) + momentum*t; p' = p - lr*t' (``fused_sgd_update``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from gqx_torch import resolve_device
from gqx_torch.compress import IdenticalCompressor
from gqx_torch.config import resolve_schedule
from gqx_torch.convert import leaf_paths
from gqx_torch.models.common import clear_batch_stats, update_running_stats
from gqx_torch.models.folded import folded_users
from gqx_torch.parallel.aggregate import AggState, init_state, make_aggregator
from gqx_torch.parallel.collectives import init_mesh_state, make_mesh_train_step
from gqx_torch.parallel.packing import UnitPlan, plan_units


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    trace: Dict[str, torch.Tensor]   # momentum trace per parameter name
    agg_state: AggState = dataclasses.field(default_factory=AggState)
    step: int = 0


def create_train_state(config, model: nn.Module, device="cuda") -> Tuple[TrainState, UnitPlan]:
    """Move ``model`` to ``device``, build the compression unit plan (in
    gqx's leaf order; a VQ codebook that no file holds is trained on
    ``device``), zero momentum and zero error-feedback state.  Returns
    (state, plan).  With ``backend="mesh"`` the error-feedback state is
    this rank's (``collectives.init_mesh_state``): the process group must
    be open.

    On a CUDA device with float32 compute, TF32 is switched off for cuDNN
    convolutions and cuBLAS matmuls (process-wide flags), so float32 means
    float32 as it does in gqx; with bf16 compute, cuBLAS may not reduce in
    bf16, so every product is accumulated in float32 as gqx's are."""
    config.validate()
    dev = resolve_device(device)
    if dev.type == "cuda" and config.compute_dtype == "float32":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    if dev.type == "cuda" and config.compute_dtype == "bfloat16":
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    model.to(dev).train()
    params = dict(model.named_parameters())
    plan = plan_units([(n, tuple(p.shape)) for n, p in params.items()],
                      leaf_paths(model), config, device=dev)
    trace = {n: torch.zeros_like(p) for n, p in params.items()}
    if config.backend == "mesh":
        agg_state = init_mesh_state(config, plan, dev)
    else:
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


def folded_user_grads(model: nn.Module, plan: UnitPlan, names, x: torch.Tensor,
                      y: torch.Tensor):
    """Per-user losses (U,) and gradients {name: (U, *shape)} float32 from
    one forward/backward on the folded (U*B) batch (gqx/train.py:152-242).

    The loss is the sum over users of each user's mean cross-entropy, so
    each user's gradient is that of its own mean loss.  Parameters that a
    folded layer covers with a ghost (conv and dense weights, BN scale and
    bias) get their true per-user gradient.  Any other leaf (a dense bias)
    gets the folded total / U for every user, which aggregates to the same
    value only in an identity unit (a linear round trip with no error): a
    compressed unit holding such a leaf raises.  Each BatchNorm records its
    (U, C) batch statistics."""
    users, batch = x.shape[0], x.shape[1]
    params = dict(model.named_parameters())
    with folded_users(users) as folded:
        logits = model(x.reshape((users * batch,) + tuple(x.shape[2:])))
    losses = F.cross_entropy(logits, y.reshape(-1), reduction="none").reshape(users, batch).mean(1)
    ghosts = folded.ghosts
    uncovered = {n for n in names if params[n] not in ghosts}
    for unit in plan.units:
        if isinstance(unit.compressor, IdenticalCompressor):
            continue
        bad = {plan.names[i] for i in unit.leaf_indices} & uncovered
        if bad:
            raise ValueError(
                f"folded_users: {sorted(bad)} are compressed but get no per-user gradient "
                "from a folded layer; use folded_users=False for this model")
    targets = [params[n] if n in uncovered else ghosts[params[n]] for n in names]
    grads = {}
    for n, g in zip(names, torch.autograd.grad(losses.sum(), targets)):
        grads[n] = (g / users).to(torch.float32).expand((users,) + tuple(g.shape)) \
            if n in uncovered else g
    return losses.detach(), grads


def make_train_step(config, plan: UnitPlan) -> Callable:
    """step(state, x (U, B, C, H, W), y (U, B), lr, wd, generator, scale=1.0)
    -> mean loss.  ``generator`` (a CPU ``torch.Generator``) seeds the
    compressor's stochastic rounding; it may be None with ``random=False``.
    ``scale`` multiplies the error-feedback error before it is added to the
    gradient (``config.ef_scale(epoch)``); it is unused without EF.

    With ``config.folded_users`` the per-user gradients come from
    ``folded_user_grads``, else from the loop of ``user_grads``, on either
    backend (gqx/train.py:102-103; gqx's mesh step folds too).
    ``backend="mesh"`` is the distributed step
    (``collectives.make_mesh_train_step``): x and y hold this rank's users.
    """
    if config.backend == "mesh":
        return make_mesh_train_step(config, plan)
    aggregator = make_aggregator(config, plan)
    momentum = resolve_schedule(config)[4]
    folded = bool(config.folded_users)

    def train_step(state: TrainState, x, y, lr: float, wd: float,
                   generator: Optional[torch.Generator], scale: float = 1.0):
        model = state.model
        dev = next(model.parameters()).device
        if x.device != dev or y.device != dev:
            raise ValueError(f"batch on {x.device}/{y.device}, model on {dev}")
        clear_batch_stats(model)
        if folded:
            losses, grads = folded_user_grads(model, plan, plan.names, x, y)
        else:
            losses, grads = user_grads(model, plan.names, x, y)
        agg = aggregator(grads, state.agg_state, scale, generator)
        fused_sgd_update(agg, dict(model.named_parameters()), state.trace,
                         lr, wd, momentum)
        update_running_stats(model)
        state.step += 1
        return losses.mean()

    return train_step


def make_eval_step(model: nn.Module) -> Callable:
    """eval_step(x (N, C, H, W), y (N,)) -> (mean cross-entropy, number of
    correct predictions) of ``model`` with its running BN statistics; the
    model is left in the mode it was in."""

    @torch.no_grad()
    def eval_step(x, y):
        was_training = model.training
        model.eval()
        try:
            logits = model(x)
        finally:
            model.train(was_training)
        return F.cross_entropy(logits, y), (logits.argmax(-1) == y).sum()

    return eval_step


def evaluate(eval_step: Callable,
             batches: Iterable[Tuple[torch.Tensor, torch.Tensor]]) -> Tuple[float, float]:
    """Full test-set evaluation (reference main.py:236-255): (loss,
    accuracy).  The loss is the reference's: the sum of the per-batch *mean*
    cross-entropies over the dataset size (gqx/train.py:291-303), so logged
    curves compare directly."""
    total_loss, total_correct, total_n = 0.0, 0, 0
    for x, y in batches:
        loss, correct = eval_step(x, y)
        total_loss += float(loss)
        total_correct += int(correct)
        total_n += len(y)
    return total_loss / max(total_n, 1), total_correct / max(total_n, 1)
