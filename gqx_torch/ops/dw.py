"""Per-user convolution weight gradient (counterpart of ``gqx/ops/pallas_dw.py``).

The folded-users backward (``gqx_torch.models.folded``) runs one forward and
one data-gradient backward on the folded (U*B) batch and needs one weight
gradient per user:

    dW[u, co, ci, i, j] = sum over the images b of user u and over (h, w) of
        xpad[b, ci, h + i - ph, w + j - pw] * dy[b, co, h, w]

for a stride-1 convolution whose output has the input's size (kh - 1 pad
rows and kw - 1 pad columns in all, ``ph`` and ``pw`` of them on the low
side).  Tensors are in the port's layout: ``x`` (U*B, Ci, H, W) and ``dy``
(U*B, Co, H, W), float32 or bf16, and the result (U, Co, Ci, kh, kw) is
float32 in the weight's OIHW order.  Operands enter as float32 and the sum
is float32; the caller rounds the result to its compute dtype where gqx
does.

``per_user_dw`` computes the plain version for CPU tensors and launches the
CUDA kernel (``csrc/per_user_dw.cu``) for CUDA tensors; there is no fallback
from one to the other.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from gqx_torch.ops import _build

#: launches of the CUDA kernel (not of the plain version)
launches = 0

MAX_KW = 7            # the kernel keeps a kw-wide window in registers
_TILE_CO = 64         # output channels per block
_BLOCKS_PER_SM = 2    # blocks wanted per multiprocessor before the batch is split


def _check(x, dy, users, kh, kw, ph, pw):
    if x.dim() != 4 or dy.dim() != 4:
        raise ValueError(f"per_user_dw: x and dy must be NCHW, got {tuple(x.shape)} "
                         f"and {tuple(dy.shape)}")
    if x.shape[0] != dy.shape[0] or x.shape[2:] != dy.shape[2:]:
        raise ValueError(f"per_user_dw: dy {tuple(dy.shape)} does not have the batch and "
                         f"size of x {tuple(x.shape)} (a stride-1 same-size conv)")
    if users < 1 or x.shape[0] % users:
        raise ValueError(f"per_user_dw: batch {x.shape[0]} does not fold {users} users")
    if kh < 1 or kw < 1 or not (0 <= ph < kh and 0 <= pw < kw):
        raise ValueError(f"per_user_dw: window {kh}x{kw} with low pads ({ph}, {pw})")
    if x.dtype != dy.dtype or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"per_user_dw: x and dy must both be float32 or bfloat16, got "
                         f"{x.dtype} and {dy.dtype}")


def per_user_dw_plain(x: torch.Tensor, dy: torch.Tensor, users: int,
                      kh: int, kw: int, ph: int, pw: int) -> torch.Tensor:
    """The plain version (gqx's ``_per_user_dw_einsum``): kh*kw shifted
    slices of the padded input, each contracted with dy over (b, h, w) per
    user, with float32 operands."""
    _check(x, dy, users, kh, kw, ph, pw)
    _, ci, h, w = x.shape
    co = dy.shape[1]
    xp = F.pad(x.to(torch.float32), (pw, kw - 1 - pw, ph, kh - 1 - ph))
    xu = xp.reshape(users, -1, ci, h + kh - 1, w + kw - 1)
    dyu = dy.to(torch.float32).reshape(users, -1, co, h, w)
    taps = [torch.einsum("ubihw,ubohw->uoi", xu[..., i:i + h, j:j + w], dyu)
            for i in range(kh) for j in range(kw)]
    return torch.stack(taps, dim=-1).reshape(users, co, ci, kh, kw)


def batch_splits(users: int, batch: int, ci: int, co: int, kh: int, sm_count: int) -> int:
    """Into how many ranges the kernel cuts a user's images.  The blocks,
    one per (user, tap row, channel tile, range), run ``_BLOCKS_PER_SM`` per
    multiprocessor in waves; a last wave that is nearly empty costs as much
    as a full one.  So: the fewest ranges (at most 16) that fill the card at
    least once and whose waves are at least 90% full, counting a range as
    long as its longest; failing that, the best filled.  A function of the
    shapes and the card only, so the order of the sum, and with it every bit
    of the result, repeats."""
    ci_tile = 16 if ci <= 16 else 64
    blocks = users * kh * -(-ci // ci_tile) * -(-co // _TILE_CO)
    slots = _BLOCKS_PER_SM * sm_count
    best, best_fill = 1, 0.0
    for want in range(1, min(batch, 16) + 1):
        per = -(-batch // want)
        splits = -(-batch // per)
        waves = -(-blocks * splits // slots)
        # useful image-blocks over what the waves could hold
        fill = blocks * batch / (waves * slots * per)
        if fill > best_fill + 1e-9:
            best, best_fill = splits, fill
        if fill >= 0.9:
            break
    return best


def _kernel(x, dy, users, kh, kw, ph, pw):
    if not (x.is_contiguous() and dy.is_contiguous()) or x.device != dy.device:
        raise ValueError("per_user_dw: x and dy must be contiguous on one device")
    if kw > MAX_KW or x.shape[2] >= 1 << 15:
        raise NotImplementedError(f"per_user_dw: no CUDA kernel for kw {kw} > {MAX_KW} "
                                  f"or {x.shape[2]} >= 32768 rows")
    n, ci, h, w = x.shape
    co = dy.shape[1]
    batch = n // users
    out = torch.empty((users, co, ci, kh, kw), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    if n == 0 or h * w == 0:
        return out.zero_()
    sm_count = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits = batch_splits(users, batch, ci, co, kh, sm_count)
    scratch = (torch.empty((splits,) + tuple(out.shape), dtype=torch.float32, device=x.device)
               if splits > 1 else None)
    lib = _build.load("per_user_dw")
    fn = lib.gqx_per_user_dw
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 12 + \
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), dy.data_ptr(), int(x.dtype == torch.bfloat16), users, batch,
             ci, co, h, w, kh, kw, ph, pw, splits,
             scratch.data_ptr() if scratch is not None else None, out.data_ptr(),
             _build.stream_ptr(x.device))
    _build.check(lib, err, "per_user_dw")
    global launches
    launches += 1
    return out


def per_user_dw(x: torch.Tensor, dy: torch.Tensor, users: int,
                kh: int, kw: int, ph: int, pw: int) -> torch.Tensor:
    """x (U*B, Ci, H, W), dy (U*B, Co, H, W), both float32 or both bf16 ->
    the per-user weight gradient (U, Co, Ci, kh, kw) float32 of a stride-1
    kh x kw convolution with low pads (ph, pw) whose output has the input's
    size.  Two calls on the same inputs give the same bits."""
    _check(x, dy, users, kh, kw, ph, pw)
    if x.device.type == "cpu":
        return per_user_dw_plain(x, dy, users, kh, kw, ph, pw)
    if x.device.type != "cuda":
        raise ValueError(f"per_user_dw: unsupported device {x.device}")
    return _kernel(x, dy, users, kh, kw, ph, pw)
