"""Compressor protocol (counterpart of ``gqx/compress/api.py``).

A compressor's configuration is fixed at construction; ``compress`` and
``decompress`` are functions of tensors.  Randomness is explicit: the
stochastic compressors take a ``torch.Generator`` from which they draw the
seeds of their uniforms.  Signatures ("sig") are dicts of tensors; the
batched API works on a leading users axis.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from gqx_torch.ops.rand import uniform

Sig = Dict[str, Any]


class Compressor:
    """Base class; subclasses override the core API."""

    def __init__(self, size: int, shape: Tuple[int, ...]):
        self.size = int(size)
        self.shape = tuple(shape)

    # -- core API -----------------------------------------------------------
    def compress(self, vec: torch.Tensor, generator: Optional[torch.Generator] = None) -> Sig:
        raise NotImplementedError

    def decompress(self, sig: Sig) -> torch.Tensor:
        raise NotImplementedError

    # -- batched (stacked-users) API -----------------------------------------
    def compress_batch(self, vecs: torch.Tensor, generator=None) -> Sig:
        """vecs (U, *shape) -> signature with a leading U axis per leaf."""
        raise NotImplementedError

    def decompress_batch(self, sig: Sig) -> torch.Tensor:
        raise NotImplementedError

    def decode_mean(self, sig: Sig) -> torch.Tensor:
        """Mean over users of the decompressed signatures — the PS server
        reduce (reference ps_quantizer.py:48)."""
        dec = self.decompress_batch(sig)
        return dec.sum(0) / dec.shape[0]

    @property
    def wire_bits(self) -> int:
        raise NotImplementedError


def subvector_dim(size: int, c_dim: int, max_tries: int = 10) -> int:
    """The reference's bucket-dimension fixup: repeatedly ``dim = dim // 2 * 3``
    until ``size % dim == 0`` (whole tensor if c_dim is 0 or > size)."""
    if c_dim == 0 or size < c_dim:
        return size
    dim = c_dim
    for _ in range(max_tries):
        if size % dim != 0:
            dim = dim // 2 * 3
    if size % dim != 0:
        raise ValueError(f"not divisible: size {size} c_dim {c_dim} dim {dim}")
    return dim


def draw_seed(generator: Optional[torch.Generator]) -> int:
    """A 62-bit seed for the counter-based uniforms, drawn from ``generator``
    on the host (no device synchronisation)."""
    hi, lo = torch.randint(0, 1 << 31, (2,), generator=generator).tolist()
    return (hi << 31) | lo


def stochastic_increment(
    scaled: torch.Tensor, floored: torch.Tensor,
    generator: Optional[torch.Generator],
) -> torch.Tensor:
    """l += (scaled - l > U(0,1)) — the reference's stochastic rounding
    (reference qsgd_compressor.py:55-61).  Returns int32 increments.

    The float32 uniforms come from the counter-based Philox generator of
    ``gqx_torch.ops.rand``, seeded from ``generator``: one kernel launch for
    every user on a CUDA device, its plain version on the CPU.  gqx draws
    small or non-float32 inputs with threefry instead (gqx/compress/api.py:
    143), a condition of its Pallas tiling that has no counterpart here."""
    probabilities = scaled - floored.to(scaled.dtype)
    r = uniform(draw_seed(generator), 0, tuple(floored.shape), scaled.device)
    return (probabilities > r).to(torch.int32)


def code_dtype(k_bit: int) -> torch.dtype:
    """uint8 codes for k_bit <= 8 else int32."""
    return torch.uint8 if k_bit <= 8 else torch.int32
