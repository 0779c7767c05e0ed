"""Grouped training batch norm: the forward and backward of
``gqx_torch.models.folded.GroupedBatchNorm``.

x (U*B, C, H, W) is normalised per (user, channel) group of n = B*H*W
elements with gqx's numerics (gqx/models/folded.py:250-296), in float32:

    mean = sum(x) / n, var = max(0, sum(x^2) / n - mean^2), inv = rsqrt(var + eps)
    y    = ((x - mean) * inv) * w + b                      (rounded to x's dtype)
    s1   = sum(dy), s2 = sum(dy * ((x - mean) * inv))
    dx   = g1 * dy - g2 + (x - mean) * g5, with g1 = w * inv, g2 = s1 * g1 / n,
           g5 = [var > 0] * -(s2 * g1 * inv) / n

``grouped_bn_forward`` and ``grouped_bn_backward`` compute the plain
version for CPU tensors and launch a kernel of ``csrc/grouped_bn.cu`` for
CUDA tensors (bf16 or float32, NCHW contiguous); there is no fallback from
one to the other.  The kernels replace no TPU kernel (gqx leaves this chain
to XLA); they read each group from device memory once, where the plain
version makes about ten float32 passes each way.  ``plan`` chooses the
route and the block's tile from a group's shape, the channels, the dtype
and the card's shared memory alone, never from the number of users: a
group gives the same bits whether the folded step normalises it beside
the other users' or the per-user loop alone.  The routes:

- ``"smem"``: a block keeps its groups in shared memory between their sums
  and its output, so x (and dy) is read once;
- ``"two_pass"``: the groups do not fit (float32 backward at 32 images of
  32x32, or larger batches), and the output pass reads them again, mostly
  from L2.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from gqx_torch.ops import _build

SMEM, TWO_PASS = "smem", "two_pass"
FORWARD, BACKWARD = "forward", "backward"

#: launches of the CUDA kernels (not of the plain version), and by direction
#: and route (``"forward.smem"``, ...); ``launches`` is always the sum of
#: ``launches_by_route``
launches = 0
launches_by_route = {f"{d}.{r}": 0 for d in (FORWARD, BACKWARD) for r in (SMEM, TWO_PASS)}

SMALL_BLOCK, LARGE_BLOCK = 256, 1024   # threads of a block, the kernels' two sizes
MAX_TILE = SMALL_BLOCK // 8            # channels of a block at most (8 threads each)
TILE_BYTES = 32 * 1024   # bytes of x a block takes where whole groups allow
RESERVED = 1024          # shared memory a block keeps beside its groups
MAX_USERS = 65535        # the grid's second dimension


@dataclasses.dataclass(frozen=True)
class Plan:
    route: str   # SMEM or TWO_PASS
    tile: int    # channels of a block, a power of two
    threads: int  # threads of a block
    vec: int     # elements a thread moves in one access (16 bytes where H*W allows)
    smem: int    # shared memory of a block's staged groups, bytes


@functools.lru_cache(maxsize=None)
def plan(batch: int, channels: int, hw: int, dtype: torch.dtype, backward: bool,
         smem_optin: int) -> Plan:
    """The route, tile and access width of a kernel call on ``batch``
    images a user, from the shapes, the dtype and the card's shared memory
    (``smem_optin``, the most a block may take) alone.  A block owns one
    user and ``tile`` channels: whole groups, so no sum crosses blocks.  The
    tile grows (in powers of two, to at most ``MAX_TILE``) while the block's
    x stays within ``TILE_BYTES``, so that small planes (4x4, 2x2) are read
    as slabs of many channels, and shrinks until its staged groups fit the
    shared memory.  A block has ``SMALL_BLOCK`` threads, or ``LARGE_BLOCK``
    where its staged groups take more than half of the shared memory, so
    that the one block a multiprocessor holds keeps as many loads in flight
    as four would.  The users only add blocks: the order of a group's sums,
    which the tile, threads and access width fix, is the same for any
    number of them."""
    size = dtype.itemsize
    group = batch * hw * size
    staged_group = group * (2 if backward else 1)
    budget = smem_optin - RESERVED
    staged = staged_group <= budget
    tile = 1
    while tile < MAX_TILE and tile < channels and 2 * tile * group <= TILE_BYTES:
        tile *= 2
    while staged and tile > 1 and tile * staged_group > budget:
        tile //= 2
    vec = 16 // size
    while hw % vec:
        vec //= 2
    smem = tile * staged_group if staged else 0
    threads = LARGE_BLOCK if 2 * smem > smem_optin else SMALL_BLOCK
    return Plan(SMEM if staged else TWO_PASS, tile, threads, vec, smem)


def forward_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, users: int,
                  eps: float):
    """The plain version of the forward: (y, mean, var, inv)."""
    shape = x.shape
    xg = x.reshape((users, -1) + tuple(shape[1:]))
    xf = xg.to(torch.promote_types(x.dtype, torch.float32))
    mean = xf.mean(dim=(1, 3, 4))
    var = torch.clamp_min((xf * xf).mean(dim=(1, 3, 4)) - mean * mean, 0.0)
    inv = torch.rsqrt(var + eps)
    y = (xf - mean[:, None, :, None, None]) * inv[:, None, :, None, None]
    y = y * weight[:, None, None] + bias[:, None, None]
    return y.to(x.dtype).reshape(shape), mean, var, inv


def backward_plain(x: torch.Tensor, dy: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                   inv: torch.Tensor, weight: torch.Tensor, users: int):
    """The plain version of the backward: (dx, s2, s1)."""
    shape = x.shape
    n = x.numel() // (users * shape[1])
    xc = (x.reshape((users, -1) + tuple(shape[1:])).to(mean.dtype)
          - mean[:, None, :, None, None])
    dyf = dy.reshape((users, -1) + tuple(shape[1:])).to(mean.dtype)
    s1 = dyf.sum(dim=(1, 3, 4))
    s2 = (dyf * (xc * inv[:, None, :, None, None])).sum(dim=(1, 3, 4))
    g1 = weight * inv
    g2 = s1 * g1 / n
    g5 = (var > 0).to(var.dtype) * -(s2 * g1 * inv) / n
    dx = (g1[:, None, :, None, None] * dyf - g2[:, None, :, None, None]
          + xc * g5[:, None, :, None, None])
    return dx.to(x.dtype).reshape(shape), s2, s1


def _check_x(x, users, what):
    if x.dim() != 4:
        raise ValueError(f"grouped_bn {what}: x must be NCHW, got {tuple(x.shape)}")
    if users < 1 or x.shape[0] % users:
        raise ValueError(f"grouped_bn {what}: batch {x.shape[0]} does not fold {users} users")


def _check_cuda(x, channel_params, stats, users, what):
    """The kernels' conditions on a CUDA call: x bf16 or float32 and NCHW
    contiguous, the per-channel (C,) and per-group (U, C) float32 operands
    contiguous on x's device."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"grouped_bn {what}: x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"grouped_bn {what}: x must be NCHW contiguous")
    for t in channel_params + stats:
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"grouped_bn {what}: weights and statistics must be contiguous "
                             f"float32 on {x.device}, got {t.dtype} on {t.device}")
    for t in channel_params:
        if tuple(t.shape) != (x.shape[1],):
            raise ValueError(f"grouped_bn {what}: a channel parameter of shape "
                             f"{tuple(t.shape)} for {x.shape[1]} channels")
    for t in stats:
        if tuple(t.shape) != (users, x.shape[1]):
            raise ValueError(f"grouped_bn {what}: statistics of shape {tuple(t.shape)} for "
                             f"{users} users of {x.shape[1]} channels")


@functools.lru_cache(maxsize=None)
def _entries():
    lib = _build.load("grouped_bn")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.gqx_grouped_bn_smem_optin.argtypes = [i, ctypes.POINTER(i)]
    lib.gqx_grouped_bn_smem_optin.restype = i
    fwd = lib.gqx_grouped_bn_forward
    fwd.argtypes = [ptr, ptr, ptr] + [i] * 9 + [ctypes.c_float] + [ptr] * 5
    fwd.restype = i
    bwd = lib.gqx_grouped_bn_backward
    bwd.argtypes = [ptr] * 6 + [i] * 9 + [ptr] * 4
    bwd.restype = i
    return lib, fwd, bwd


@functools.lru_cache(maxsize=None)
def block_smem(index: int) -> int:
    """The shared memory a block may opt into on CUDA device ``index``."""
    lib = _entries()[0]
    optin = ctypes.c_int()
    _build.check(lib, lib.gqx_grouped_bn_smem_optin(index, ctypes.byref(optin)),
                 "grouped_bn: shared memory per block")
    return optin.value


def _launch_plan(x, users, backward, operands):
    """The plan of a CUDA call, its access width narrowed to the operands'
    alignment."""
    n, c, h, w = x.shape
    if x.numel() == 0:
        raise NotImplementedError("grouped_bn: no CUDA kernel for an empty batch")
    if users > MAX_USERS or (n // users) * h * w >= 1 << 31:
        raise NotImplementedError(f"grouped_bn: no CUDA kernel for {users} users of "
                                  f"{n // users} x {h}x{w}")
    p = plan(n // users, c, h * w, x.dtype, backward,
             block_smem(x.device.index if x.device.index is not None
                        else torch.cuda.current_device()))
    vec = p.vec
    while vec > 1 and any(t.data_ptr() % (vec * x.element_size()) for t in operands):
        vec //= 2
    return p, vec


def _count(direction, route):
    global launches
    launches += 1
    launches_by_route[f"{direction}.{route}"] += 1


def grouped_bn_forward(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, users: int,
                       eps: float):
    """x (U*B, C, H, W), weight and bias (C,) -> (y like x, mean, var, inv
    (U, C) float32).  Two calls on the same inputs give the same bits."""
    _check_x(x, users, FORWARD)
    if x.device.type == "cpu":
        return forward_plain(x, weight, bias, users, eps)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_bn: unsupported device {x.device}")
    _check_cuda(x, (weight, bias), (), users, FORWARD)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    mean, var, inv = (torch.empty((users, x.shape[1]), dtype=torch.float32, device=x.device)
                      for _ in range(3))
    p, vec = _launch_plan(x, users, False, (x, y))
    n, c, h, w = x.shape
    lib, fwd, _ = _entries()
    err = fwd(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), int(x.dtype == torch.bfloat16),
              users, n // users, c, h * w, p.tile, p.threads, vec, int(p.route == SMEM), eps,
              y.data_ptr(), mean.data_ptr(), var.data_ptr(), inv.data_ptr(),
              _build.stream_ptr(x.device))
    _build.check(lib, err, f"grouped_bn forward ({p.route})")
    _count(FORWARD, p.route)
    return y, mean, var, inv


def grouped_bn_backward(x: torch.Tensor, dy: torch.Tensor, mean: torch.Tensor,
                        var: torch.Tensor, inv: torch.Tensor, weight: torch.Tensor, users: int):
    """x and dy (U*B, C, H, W), the forward's mean, var and inv (U, C) and
    weight (C,) -> (dx like x, s2, s1 (U, C) float32): s2 and s1 are the
    per-user gradients of the scale and the bias.  Two calls on the same
    inputs give the same bits."""
    _check_x(x, users, BACKWARD)
    if dy.shape != x.shape:
        raise ValueError(f"grouped_bn backward: dy {tuple(dy.shape)} for x {tuple(x.shape)}")
    if x.device.type == "cpu":
        return backward_plain(x, dy, mean, var, inv, weight, users)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_bn: unsupported device {x.device}")
    if dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"grouped_bn backward: dy {dy.dtype} on {dy.device} for x {x.dtype} "
                         f"on {x.device}")
    _check_cuda(x, (weight,), (mean, var, inv), users, BACKWARD)
    dy = dy.contiguous()
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    s1, s2 = (torch.empty((users, x.shape[1]), dtype=torch.float32, device=x.device)
              for _ in range(2))
    p, vec = _launch_plan(x, users, True, (x, dy, dx))
    n, c, h, w = x.shape
    lib, _, bwd = _entries()
    err = bwd(x.data_ptr(), dy.data_ptr(), mean.data_ptr(), var.data_ptr(), inv.data_ptr(),
              weight.data_ptr(), int(x.dtype == torch.bfloat16), users, n // users, c, h * w,
              p.tile, p.threads, vec, int(p.route == SMEM), dx.data_ptr(), s1.data_ptr(),
              s2.data_ptr(),
              _build.stream_ptr(x.device))
    _build.check(lib, err, f"grouped_bn backward ({p.route})")
    _count(BACKWARD, p.route)
    return dx, s2, s1
