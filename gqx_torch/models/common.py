"""Layers shared by the port's models (counterpart of ``gqx/models/common.py``).

Parameters are float32; ``dtype`` is the compute dtype, and layers cast
their inputs and weights to it explicitly at the conv/dense (no autocast),
so the roundings sit where gqx puts them.  Activations are NCHW, conv
weights OIHW.

Numerics carried over from gqx:
  - ``Conv2d`` pads like XLA's "SAME": for a stride-2 3x3 conv on an even
    input that is (0, 1), not (1, 1).
  - ``BatchNorm`` in training normalizes with the statistics of the batch it
    is given, with the biased, clipped "fast variance" max(0, E[x^2] -
    E[x]^2) and eps 1e-5, in float32, and casts back to the input dtype.  It
    does not touch its running statistics in the forward: it records the
    batch statistics, and ``update_running_stats`` folds the mean over users
    into the running statistics with momentum 0.9 in flax's sense (gqx's
    folded BN, gqx/models/common.py:269-317 and folded.py:198-210).

Inside a ``folded_users(U)`` context (``gqx_torch.models.folded``) the three
layers take a folded (U*B, ...) batch: ``Conv2d`` and ``Dense`` compute the
same forward and hand their weights' gradients out per user, and
``BatchNorm`` normalizes each user's micro-batch with its own statistics.
Parameter names and ``flax_path``s are the same on both routes.

Every module carries ``flax_path``, its path segment in gqx's flax tree,
from which ``gqx_torch.convert`` derives each parameter's gqx leaf path.
"""

from __future__ import annotations

import collections
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from gqx_torch.models.folded import (GroupedBatchNorm, SharedConv, SharedDense,
                                     active_folded_users)
from gqx_torch.utils.profiling import span


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's "SAME" padding (lo, hi) for one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class Conv2d(nn.Module):
    """Conv with torch's default init, "SAME" (XLA's) or "VALID" padding and,
    with ``bias``, a bias added after the convolution in the compute dtype,
    as gqx adds it (a bf16 result is rounded before the bias and again
    after it).  The bias has no ghost: in the folded step its gradient is
    the folded total, as a ``Dense`` bias's is."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32, flax_path: str = "",
                 bias: bool = False, padding: str = "SAME"):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        self.stride = stride
        self.padding = padding
        self.dtype = dtype
        self.flax_path = flax_path

    def reset_parameters(self, generator: Optional[torch.Generator]):
        bound = 1.0 / math.sqrt(self.weight[0].numel())
        nn.init.uniform_(self.weight, -bound, bound, generator=generator)
        if self.bias is not None:
            nn.init.uniform_(self.bias, -bound, bound, generator=generator)

    def forward(self, x):
        k = self.weight.shape[-1]
        if self.padding == "VALID":
            ph = pw = (0, 0)
        else:
            ph = same_pads(x.shape[-2], k, self.stride)
            pw = same_pads(x.shape[-1], k, self.stride)
        folded = active_folded_users()
        if folded is not None:
            y = SharedConv.apply(x.to(self.dtype), self.weight.to(self.dtype),
                                 folded.ghost_for(self.weight), folded.users,
                                 self.stride, ph + pw)
        else:
            if any(ph + pw):
                x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
            y = F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), stride=self.stride)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)[:, None, None]
        return y


class Dense(nn.Module):
    """Linear layer with torch's default init."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype = torch.float32,
                 flax_path: str = ""):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout))
        self.dtype = dtype
        self.flax_path = flax_path

    def reset_parameters(self, generator: Optional[torch.Generator]):
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        nn.init.uniform_(self.weight, -bound, bound, generator=generator)
        nn.init.uniform_(self.bias, -bound, bound, generator=generator)

    def forward(self, x):
        d = self.dtype
        folded = active_folded_users()
        if folded is not None:
            # the bias has no ghost: its gradient is the folded total
            y = SharedDense.apply(x.to(d), self.weight.to(d),
                                  folded.ghost_for(self.weight), folded.users)
            return y + self.bias.to(d)
        return F.linear(x.to(d), self.weight.to(d), self.bias.to(d))


class BatchNorm(nn.Module):
    """BatchNorm2d with gqx's numerics (see the module docstring)."""

    momentum = 0.9   # flax's sense: new = m * old + (1 - m) * batch
    eps = 1e-5

    def __init__(self, c: int, flax_path: str = ""):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.flax_path = flax_path
        self.batch_stats: List[Tuple[torch.Tensor, torch.Tensor]] = []

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x):
        with span("gqx_torch::bn.forward"):
            if not self.training:
                inv = torch.rsqrt(self.running_var + self.eps)
                y = (x.to(torch.float32) - self.running_mean[:, None, None]) * inv[:, None, None]
                y = y * self.weight[:, None, None] + self.bias[:, None, None]
                return y.to(x.dtype)
            folded = active_folded_users()
            if folded is None:
                users, ghost_w, ghost_b = 1, None, None
            else:
                users = folded.users
                ghost_w, ghost_b = folded.ghost_for(self.weight), folded.ghost_for(self.bias)
            y, mean, var = GroupedBatchNorm.apply(x, self.weight, self.bias, ghost_w, ghost_b,
                                                  users, self.eps)
            self.batch_stats.append((mean, var))
            return y


@torch.no_grad()
def update_running_stats(model: nn.Module) -> None:
    """Fold the batch statistics recorded since the last call (one (1, C)
    entry per user from the per-user loop, or one (U, C) entry from the
    folded step) into each BatchNorm's running statistics: the mean over
    users, with momentum 0.9 — gqx's update (gqx/models/common.py:313-316)."""
    with span("gqx_torch::update.bn_stats"):
        for mod in model.modules():
            if isinstance(mod, BatchNorm) and mod.batch_stats:
                mean_u = torch.cat([m for m, _ in mod.batch_stats]).mean(0)
                var_u = torch.cat([v for _, v in mod.batch_stats]).mean(0)
                m = mod.momentum
                mod.running_mean.copy_(m * mod.running_mean + (1 - m) * mean_u)
                mod.running_var.copy_(m * mod.running_var + (1 - m) * var_u)
                mod.batch_stats.clear()


def clear_batch_stats(model: nn.Module) -> None:
    for mod in model.modules():
        if isinstance(mod, BatchNorm):
            mod.batch_stats.clear()


def batch_norm_planes(model: nn.Module) -> Dict[Tuple[int, int, int], int]:
    """{(C, H, W): count} of the inputs of ``model``'s batch norms at the
    model's own image shape, read off one forward of one zero image in eval
    mode; ``model`` must be on the CPU, and keeps its mode."""
    found = collections.Counter()
    hooks = [m.register_forward_pre_hook(
        lambda mod, inputs: found.update([tuple(inputs[0].shape[1:])]))
        for m in model.modules() if isinstance(m, BatchNorm)]
    training = model.training
    h, w, c = model.image_shape
    try:
        with torch.no_grad():
            model.eval()(torch.zeros(1, c, h, w))
    finally:
        model.train(training)
        for hook in hooks:
            hook.remove()
    return dict(found)


def reset_parameters(model: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Re-initialize every layer from ``generator`` (torch's default init)."""
    for mod in model.modules():
        if isinstance(mod, (Conv2d, Dense, BatchNorm)):
            mod.reset_parameters(generator)


def max_pool(x: torch.Tensor, window: int, stride: Optional[int] = None) -> torch.Tensor:
    """gqx's ``max_pool``: VALID windows; a tied window's gradient goes to
    its first maximum in row-major order, in both packages."""
    return F.max_pool2d(x, window, stride or window)


def avg_pool(x: torch.Tensor, window: int, stride: Optional[int] = None) -> torch.Tensor:
    """gqx's ``avg_pool``: VALID windows."""
    return F.avg_pool2d(x, window, stride or window)


def check_classifier_input(network: str, image_shape, side_h: int, side_w: int) -> None:
    """Raise where ``image_shape`` pools to an empty map before the
    classifier (gqx dies there with a ZeroDivisionError in its init)."""
    if side_h < 1 or side_w < 1:
        raise ValueError(f"{network}: image shape {tuple(image_shape)} pools to an empty "
                         f"{side_h}x{side_w} map before the classifier")


def nhwc_flatten(x: torch.Tensor) -> torch.Tensor:
    """Flatten an NCHW tensor in gqx's NHWC element order, so a dense layer
    after it sees the same feature order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
