"""Folded-users layers (counterpart of ``gqx/models/folded.py``).

Every user needs its own gradient, but all users share the parameters.  So
the forward and the data-gradient backward run once, on the folded (U*B)
batch, and only the weight gradients are kept apart per user:

  - ``SharedConv``: the ordinary convolution forward; its backward takes
    ``dx`` from the library on the folded batch and the per-user weight
    gradient by gqx's routing: the hand-written kernel of
    ``gqx_torch.ops.dw`` for a stride-1 KxK (K > 1) conv whose output has
    the input's size, a batched contraction for a 1x1 conv (on the
    subsampled input when strided), and the library's weight gradient per
    user slice for the other strided convs.
  - ``SharedDense``: ``dx = dy @ W`` and the per-user ``dy^T x``.
  - ``GroupedBatchNorm``: per-user batch statistics (U, C) on the folded
    batch, gqx's analytic backward per group, per-user scale and bias
    gradients (U, C); both directions in ``gqx_torch.ops.bn`` (one kernel
    launch each on the card).

How a per-user gradient reaches the caller: each function takes, beside the
shared parameter, a "ghost" of shape (U, *parameter.shape) and returns the
per-user gradient as the ghost's gradient (the parameter itself gets None).
The ghost's values are never read; ``ghost_for`` makes it a zero-stride view
of one zero, so it costs no memory, where gqx allocates real zeros.
``torch.autograd.grad(loss, ghosts)`` then yields the (U, *shape) gradients
while everything else in the backward stays folded.

A per-user weight gradient is rounded to the compute dtype and widened to
float32 again, as gqx's is (``.astype(k.dtype)`` in its backward): with bf16
compute the gradient is a bf16 value.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from gqx_torch.ops.bn import grouped_bn_backward, grouped_bn_forward
from gqx_torch.ops.dw import per_user_dw
from gqx_torch.utils.profiling import span


class FoldedUsers:
    """The active folded-users context: the number of users and the ghosts
    made so far, keyed by their parameter."""

    def __init__(self, users: int):
        self.users = int(users)
        self.ghosts: Dict[torch.nn.Parameter, torch.Tensor] = {}

    def ghost_for(self, param: torch.nn.Parameter) -> torch.Tensor:
        """A (U, *param.shape) float32 leaf that requires grad and occupies
        one element.  A parameter used twice in one forward would need its
        two gradients added; the models here use each once."""
        if param in self.ghosts:
            raise RuntimeError("folded_users: a parameter was used twice in one forward")
        ghost = torch.zeros((), dtype=torch.float32, device=param.device).expand(
            (self.users,) + tuple(param.shape)).requires_grad_(True)
        self.ghosts[param] = ghost
        return ghost


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("gqx_torch_folded_users", default=None)


@contextlib.contextmanager
def folded_users(users: int):
    """Inside this context ``Conv2d``, ``Dense`` and ``BatchNorm`` take a
    (U*B, ...) batch of ``users`` equal micro-batches and route their
    parameters' gradients per user through ghosts; yields the context, whose
    ``ghosts`` the caller differentiates."""
    ctx = FoldedUsers(users)
    token = _ACTIVE.set(ctx)
    try:
        yield ctx
    finally:
        _ACTIVE.reset(token)


def active_folded_users() -> Optional[FoldedUsers]:
    return _ACTIVE.get()


def _as_param_grad(dku: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return dku.to(dtype).to(torch.float32)


class SharedConv(torch.autograd.Function):
    """y = conv2d(pad(x), weight, stride) on the folded batch.  ``x`` is
    (U*B, Ci, H, W) unpadded, ``weight`` OIHW in x's dtype, ``pads`` =
    (top, bottom, left, right)."""

    @staticmethod
    def forward(ctx, x, weight, ghost, users, stride, pads):
        ctx.users, ctx.stride, ctx.pads = users, stride, pads
        ctx.save_for_backward(x, weight)
        return F.conv2d(_pad(x, pads), weight, stride=stride)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        users, stride, pads = ctx.users, ctx.stride, ctx.pads
        top, bottom, left, right = pads
        ci = weight.shape[1]
        dy = dy.contiguous()
        dx = None
        if ctx.needs_input_grad[0]:
            h, w = x.shape[2] + top + bottom, x.shape[3] + left + right
            dx = torch.nn.grad.conv2d_input((x.shape[0], ci, h, w), weight, dy, stride=stride)
            dx = dx[:, :, top:h - bottom, left:w - right]
        dku = None
        if ctx.needs_input_grad[2]:
            with span("gqx_torch::fwd_bwd.per_user_dw"):
                dku = _conv_dku(x, dy, weight.shape, users, stride, pads)
                dku = _as_param_grad(dku, weight.dtype)
        return dx, None, dku, None, None, None


def _conv_dku(x, dy, wshape, users, stride, pads):
    """The per-user weight gradient (U, Co, Ci, Kh, Kw) of a folded conv by
    gqx's routing (the module docstring)."""
    top, bottom, left, right = pads
    co, ci, kh, kw = wshape
    if kh * kw > 1 and stride == 1 and dy.shape[2:] == x.shape[2:]:
        return per_user_dw(x.contiguous(), dy, users, kh, kw, top, left)
    if kh * kw == 1:
        xs = x[:, :, ::stride, ::stride]
        dku = torch.einsum("ubis,ubos->uoi", xs.reshape(users, -1, ci, xs.shape[2] * xs.shape[3]),
                           dy.reshape(users, -1, co, dy.shape[2] * dy.shape[3]))
        return dku.reshape(users, co, ci, 1, 1)
    xu = _pad(x, pads).reshape((users, -1) + (ci, x.shape[2] + top + bottom,
                                              x.shape[3] + left + right))
    dyu = dy.reshape((users, -1) + tuple(dy.shape[1:]))
    return torch.stack([torch.nn.grad.conv2d_weight(xu[u], wshape, dyu[u], stride=stride)
                        for u in range(users)])


def _pad(x, pads):
    top, bottom, left, right = pads
    return F.pad(x, (left, right, top, bottom)) if any(pads) else x


class SharedDense(torch.autograd.Function):
    """y = x @ weight^T on the folded batch; x (U*B, Cin), weight (Cout, Cin)."""

    @staticmethod
    def forward(ctx, x, weight, ghost, users):
        ctx.users = users
        ctx.save_for_backward(x, weight)
        return F.linear(x, weight)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        users = ctx.users
        dx = dy @ weight if ctx.needs_input_grad[0] else None
        dku = None
        if ctx.needs_input_grad[2]:
            with span("gqx_torch::fwd_bwd.per_user_dw"):
                dku = torch.einsum("ubo,ubi->uoi", dy.reshape(users, -1, dy.shape[-1]),
                                   x.reshape(users, -1, x.shape[-1]))
                dku = _as_param_grad(dku, weight.dtype)
        return dx, None, dku, None


class GroupedBatchNorm(torch.autograd.Function):
    """Training BN over ``users`` groups of the batch: x (U*B, C, H, W) is
    normalized per (user, channel) with the biased, clipped fast variance
    max(0, E[x^2] - E[x]^2) in float32.  Returns (y, mean (U, C), var (U, C)).

    The backward is gqx's (gqx/models/folded.py:262-293): from the sums
    s1 = sum(dy) and s2 = sum(dy * xhat) per (user, channel),
    dx = scale*inv*dy - s1*scale*inv/n - (x - mean)*s2*scale*inv^2/n (the
    last term zero where the variance was clipped).  Autograd through the
    fast-variance forward would instead subtract two large terms and lose
    float32 digits wherever |mean| >> std.  ``ghost_weight``/``ghost_bias``
    (U, C) receive s2 and s1, the per-user gradients; without them (None)
    ``weight`` and ``bias`` receive their sums over the groups.  Both
    directions are ``gqx_torch.ops.bn``'s: its plain version on the CPU, its
    kernels on the card."""

    @staticmethod
    def forward(ctx, x, weight, bias, ghost_weight, ghost_bias, users, eps):
        y, mean, var, inv = grouped_bn_forward(x, weight, bias, users, eps)
        ctx.users = users
        ctx.save_for_backward(x, mean, var, inv, weight)
        ctx.mark_non_differentiable(mean, var)
        # no zero gradients made for mean and var (two fills a batch norm);
        # y is the one differentiable output, so dy is never None
        ctx.set_materialize_grads(False)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        with span("gqx_torch::bn.backward"):
            x, mean, var, inv, weight = ctx.saved_tensors
            dx, s2, s1 = grouped_bn_backward(x, dy, mean, var, inv, weight, ctx.users)
            if ctx.needs_input_grad[3]:
                return dx, None, None, s2, s1, None, None
            return dx, s2.sum(0), s1.sum(0), None, None, None, None
