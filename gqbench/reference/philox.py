"""Counter-based uniforms in plain integer ops: Philox4x32-10.

Element e of a draw is word ``e % 4`` of the Philox4x32-10 block with
counter ``e // 4 + offset`` under the 64-bit key ``seed``, mapped to a
float as ``(bits >> 8) * 2**-24``.  That is the generator the measured
program's stochastic rounding is specified to draw from (Salmon et al.,
"Parallel random numbers: as easy as 1, 2, 3", SC 2011, for the rounds and
constants), so the reference draws the same uniforms from the same seeds.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def _mulhilo(a: torch.Tensor, b: int):
    """(hi32, lo32) of a * b for 32-bit ``a`` held in int64 and a 32-bit
    constant ``b``, from 16-bit halves of ``b`` so int64 never overflows."""
    p_lo = a * (b & 0xFFFF)
    p_hi = a * (b >> 16)
    lo = (((p_hi & 0xFFFF) << 16) + p_lo) & _MASK32
    hi = (p_hi + (p_lo >> 16)) >> 16
    return hi, lo


def _philox(c0, c1, c2, c3, k0: int, k1: int):
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & _MASK32
        k1 = (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def uniform(seed: int, shape: Tuple[int, ...], device, offset: int = 0) -> torch.Tensor:
    """U[0, 1) float32 of ``shape`` from ``seed``."""
    n = math.prod(shape)
    ctr = torch.arange((n + 3) // 4, dtype=torch.int64, device=device) + int(offset)
    zero = torch.zeros_like(ctr)
    words = _philox(ctr & _MASK32, ctr >> 32, zero, zero,
                    int(seed) & _MASK32, (int(seed) >> 32) & _MASK32)
    bits = torch.stack(words, dim=1).reshape(-1)[:n]
    return ((bits >> 8).to(torch.float32) * (1.0 / (1 << 24))).reshape(shape)


def draw_seed(generator: torch.Generator) -> int:
    """A 62-bit seed from a host ``torch.Generator``: two 31-bit draws."""
    hi, lo = torch.randint(0, 1 << 31, (2,), generator=generator).tolist()
    return (hi << 31) | lo
