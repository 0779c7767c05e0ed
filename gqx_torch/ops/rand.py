"""Counter-based uniforms for stochastic rounding (counterpart of
``gqx/ops/pallas_rand.py``).

``uniform(seed, offset, shape, device)`` returns float32 values in [0, 1):
element e is word ``e % 4`` of the Philox4x32-10 block with counter
``e // 4 + offset`` under the 64-bit key ``seed``, mapped to a float as
gqx's kernel maps its bits: ``(bits >> 8) * 2**-24``.  On a CUDA device it
launches ``csrc/philox_uniform.cu``; on the CPU it computes
``uniform_plain``, the same generator in torch integer ops, so the two are
bit-equal.  Parity with gqx's TPU bits is distributional only.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from gqx_torch.ops import _build

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF

#: launches of the CUDA kernel (not of the plain version)
launches = 0


def _mulhilo(a: torch.Tensor, b: int):
    """(hi32, lo32) of a * b for a 32-bit unsigned ``a`` held in int64 and
    a 32-bit constant ``b``, without overflowing int64: the product is
    assembled from 16-bit halves of ``b``."""
    p_lo = a * (b & 0xFFFF)
    p_hi = a * (b >> 16)
    lo = (((p_hi & 0xFFFF) << 16) + p_lo) & _MASK32
    hi = (p_hi + (p_lo >> 16)) >> 16
    return hi, lo


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 on int64 tensors holding 32-bit words."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & _MASK32
        k1 = (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def uniform_plain(seed: int, offset: int, shape: Tuple[int, ...],
                  device="cpu") -> torch.Tensor:
    """The plain PyTorch version of the kernel, on any device."""
    n = math.prod(shape)
    if n == 0:
        return torch.empty(shape, dtype=torch.float32, device=device)
    ctr = torch.arange((n + 3) // 4, dtype=torch.int64, device=device) + int(offset)
    zero = torch.zeros_like(ctr)
    words = philox4x32_10(ctr & _MASK32, ctr >> 32, zero, zero,
                          int(seed) & _MASK32, (int(seed) >> 32) & _MASK32)
    bits = torch.stack(words, dim=1).reshape(-1)[:n]
    return ((bits >> 8).to(torch.float32) * (1.0 / (1 << 24))).reshape(shape)


def _kernel(seed: int, offset: int, shape, device) -> torch.Tensor:
    global launches
    out = torch.empty(shape, dtype=torch.float32, device=device)
    n = out.numel()
    if n == 0:
        return out
    lib = _build.load("philox_uniform")
    fn = lib.gqx_philox_uniform
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64,
                   ctypes.c_uint64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(out.data_ptr(), n, int(seed) & (2**64 - 1), int(offset),
             _build.stream_ptr(out.device))
    _build.check(lib, err, "philox_uniform")
    launches += 1
    return out


def uniform(seed: int, offset: int, shape: Tuple[int, ...], device) -> torch.Tensor:
    """Uniform [0, 1) float32 of ``shape`` on ``device``: the CUDA kernel on
    a CUDA device, the plain version on the CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return uniform_plain(seed, offset, tuple(shape), device)
    if device.type != "cuda":
        raise ValueError(f"uniform: unsupported device {device}")
    return _kernel(seed, offset, tuple(shape), device)
