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

Every module carries ``flax_path``, its path segment in gqx's flax tree,
from which ``gqx_torch.convert`` derives each parameter's gqx leaf path.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's "SAME" padding (lo, hi) for one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class Conv2d(nn.Module):
    """Bias-free conv with "SAME" padding and torch's default init."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32, flax_path: str = ""):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.stride = stride
        self.dtype = dtype
        self.flax_path = flax_path

    def reset_parameters(self, generator: Optional[torch.Generator]):
        bound = 1.0 / math.sqrt(self.weight[0].numel())
        nn.init.uniform_(self.weight, -bound, bound, generator=generator)

    def forward(self, x):
        k = self.weight.shape[-1]
        ph = same_pads(x.shape[-2], k, self.stride)
        pw = same_pads(x.shape[-1], k, self.stride)
        if any(ph + pw):
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), stride=self.stride)


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
        if not self.training:
            inv = torch.rsqrt(self.running_var + self.eps)
            y = (x.to(torch.float32) - self.running_mean[:, None, None]) * inv[:, None, None]
            y = y * self.weight[:, None, None] + self.bias[:, None, None]
            return y.to(x.dtype)
        y, mean, var = _TrainBatchNorm.apply(x, self.weight, self.bias, self.eps)
        self.batch_stats.append((mean, var))
        return y


class _TrainBatchNorm(torch.autograd.Function):
    """Training BN with gqx's backward (gqx/models/folded.py:262-293): the
    analytic gradient from the sums s1 = sum(dy) and s2 = sum(dy * xhat),
    dx = scale*inv*dy - s1*scale*inv/n - (x - mean)*s2*scale*inv^2/n (the
    last term zero where the variance was clipped).  Autograd through the
    fast-variance forward would instead subtract two large terms, E[x^2]'s
    and E[x]^2's, and lose float32 digits wherever |mean| >> std."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean(dim=(0, 2, 3))
        var = torch.clamp_min((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
        inv = torch.rsqrt(var + eps)
        y = (xf - mean[:, None, None]) * inv[:, None, None]
        y = y * weight[:, None, None] + bias[:, None, None]
        ctx.save_for_backward(x, mean, var, inv, weight)
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, mean, var, inv, weight = ctx.saved_tensors
        n = x.numel() // x.shape[1]
        xc = x.to(mean.dtype) - mean[:, None, None]
        dyf = dy.to(mean.dtype)
        s1 = dyf.sum(dim=(0, 2, 3))
        s2 = (dyf * (xc * inv[:, None, None])).sum(dim=(0, 2, 3))
        g1 = weight * inv
        g2 = s1 * g1 / n
        g5 = (var > 0).to(var.dtype) * -(s2 * g1 * inv) / n
        dx = g1[:, None, None] * dyf - g2[:, None, None] + xc * g5[:, None, None]
        return dx.to(x.dtype), s2, s1, None


@torch.no_grad()
def update_running_stats(model: nn.Module) -> None:
    """Fold the batch statistics recorded since the last call (one entry per
    user) into each BatchNorm's running statistics: the mean over users,
    with momentum 0.9 — gqx's update (gqx/models/common.py:313-316)."""
    for mod in model.modules():
        if isinstance(mod, BatchNorm) and mod.batch_stats:
            mean_u = torch.stack([m for m, _ in mod.batch_stats]).mean(0)
            var_u = torch.stack([v for _, v in mod.batch_stats]).mean(0)
            m = mod.momentum
            mod.running_mean.copy_(m * mod.running_mean + (1 - m) * mean_u)
            mod.running_var.copy_(m * mod.running_var + (1 - m) * var_u)
            mod.batch_stats.clear()


def clear_batch_stats(model: nn.Module) -> None:
    for mod in model.modules():
        if isinstance(mod, BatchNorm):
            mod.batch_stats.clear()


def reset_parameters(model: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Re-initialize every layer from ``generator`` (torch's default init)."""
    for mod in model.modules():
        if isinstance(mod, (Conv2d, Dense, BatchNorm)):
            mod.reset_parameters(generator)


def nhwc_flatten(x: torch.Tensor) -> torch.Tensor:
    """Flatten an NCHW tensor in gqx's NHWC element order, so a dense layer
    after it sees the same feature order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
