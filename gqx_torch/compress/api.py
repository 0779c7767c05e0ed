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
        """One vector: the batched call over a users axis of one."""
        return _index0(self.compress_batch(vec[None], generator))

    def decompress(self, sig: Sig) -> torch.Tensor:
        return self.decompress_batch(_add_axis(sig))[0]

    def roundtrip(self, vec: torch.Tensor, generator=None) -> torch.Tensor:
        """compress -> decompress (the value the aggregators use)."""
        return self.decompress(self.compress(vec, generator))

    # -- batched (stacked-users) API -----------------------------------------
    def compress_batch(self, vecs: torch.Tensor, generator=None) -> Sig:
        """vecs (U, *shape) -> signature with a leading U axis per leaf."""
        raise NotImplementedError

    def decompress_batch(self, sig: Sig) -> torch.Tensor:
        """Signature with a leading U axis -> (U, *shape)."""
        raise NotImplementedError

    def roundtrip_batch(self, vecs: torch.Tensor, generator=None) -> torch.Tensor:
        return self.decompress_batch(self.compress_batch(vecs, generator))

    def decode_mean(self, sig: Sig) -> torch.Tensor:
        """Mean over users of the decompressed signatures — the PS server
        reduce (reference ps_quantizer.py:48)."""
        return self.users_mean(self.decompress_batch(sig))

    #: add the users one by one in ``users_mean`` (see there)
    in_order_mean = False

    def users_mean(self, dec: torch.Tensor) -> torch.Tensor:
        """Mean over the leading users axis of decoded values, as the server
        reduce and the error-feedback round trip take it.  One reduction,
        in the library's order of additions, unless ``in_order_mean``: then
        user 0 + user 1 + ... in order, times float32(1/U), the same
        additions on every device, for the compressors whose mean must
        agree across devices to the bit (top-k) or whose decodes, large and
        of either sign, cancel in it (PVQ, Residual)."""
        if not self.in_order_mean:
            return dec.sum(0) / dec.shape[0]
        out = dec[0]
        for i in range(1, dec.shape[0]):
            out = out + dec[i]
        return out * (1.0 / dec.shape[0])

    @property
    def wire_bits(self) -> int:
        raise NotImplementedError


def _index0(sig):
    if isinstance(sig, dict):
        return {k: _index0(v) for k, v in sig.items()}
    return sig[0]


def _add_axis(sig):
    if isinstance(sig, dict):
        return {k: _add_axis(v) for k, v in sig.items()}
    return sig[None]


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
