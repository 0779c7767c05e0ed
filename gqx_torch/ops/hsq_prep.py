"""Codebook operand prep for the HSQ kernels (counterpart of the helpers in
``gqx/ops/pallas_hsq2.py:38-80``).

The TPU kernels contract a block-diagonal (128, B*K) expansion of the
codebook on the matrix unit; the Hopper kernels read the (K, dim) codebook
itself from shared memory, so no expansion is ported.  What carries over
is the arithmetic: the codebook is rounded to bf16-representable values, so
that a product of a bf16 value with a codeword is exact in float32, and
values are split into bf16 hi + lo parts.
"""

from __future__ import annotations

import numpy as np
import torch

LANES = 128           # the TPU layout's row width: dim must divide it
MAX_EXPANDED = 8192   # gqx's cap on B*K (B = LANES // dim)


def supports_flat(dim: int, k: int) -> bool:
    """gqx's envelope for its flat-layout kernels; the port keeps it so both
    packages pick the kernel path for the same (dim, K)."""
    return dim >= 1 and LANES % dim == 0 and (LANES // dim) * k <= MAX_EXPANDED


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to the nearest bf16 value (ties to even), kept as float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def split_hi_lo(x: torch.Tensor):
    """float32 -> (hi, lo), both bf16-representable float32, hi + lo ~ x
    (~16 mantissa bits)."""
    hi = bf16_round(x)
    return hi, bf16_round(x - hi)


def bf16_exact_codebook(codebook: np.ndarray) -> np.ndarray:
    """Round codewords to bf16-representable float32 values
    (gqx/ops/pallas_hsq2.py:68-80): with them a bf16 x codeword product is
    exact in float32, and encode and decode use the same rounded codebook."""
    t = torch.from_numpy(np.ascontiguousarray(codebook, dtype=np.float32))
    return bf16_round(t).numpy()
