"""HSQ nearest-neighbor vector quantization (counterpart of
``gqx/compress/vq.py::HSQCompressor``).

compress (reference nearest_neighbor_compressor.py:63-78): view as (M, dim)
rows; p = rows @ codebook^T; code and signed scale u by the TPU kernel's
selection; u is then quantized by the min/max scalar quantizer.
decompress (its :80-90): codebook[code] * u.

The port always runs the configuration gqx runs with ``use_pallas=True``.
Inside the flat-layout kernels' envelope (``supports_flat(dim, K)``) that is
the bf16-exact codebook and the arithmetic of ``gqx_torch.ops.hsq``; outside
it (a large K, a ragged dim) it is the raw float32 codebook and the
row-major kernels of ``gqx_torch.ops.hsq_rows``, as in gqx.  Signatures are
m-order: codes (U, M), u the norm quantizer's signature.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from gqx_torch.codebooks import get_codebook, orthonormal_codebook
from gqx_torch.compress.api import Compressor, Sig, code_dtype, subvector_dim
from gqx_torch.compress.scalar import ProbabilisticScalarCompressor
from gqx_torch.ops import hsq as hsq_ops
from gqx_torch.ops import hsq_rows
from gqx_torch.ops.hsq_prep import bf16_exact_codebook, supports_flat


class HSQCompressor(Compressor):
    """Hyper-sphere (nearest-neighbor) vector quantization."""

    def __init__(
        self,
        size: int,
        shape: Tuple[int, ...],
        c_dim: int,
        k_bit: int,
        n_bit: int,
        random: bool = True,
        codebook: Optional[np.ndarray] = None,
        codebook_seed: int = 1,
        norm_segment_sizes: Optional[Tuple[int, ...]] = None,
        passes: int = 2,
    ):
        super().__init__(size, shape)
        if not (c_dim > 0 and k_bit >= 0 and n_bit > 0):
            raise ValueError(f"bad HSQ config c_dim={c_dim} k_bit={k_bit} n_bit={n_bit}")
        if passes not in (1, 2):
            raise ValueError(f"passes must be 1 or 2, got {passes}")
        self.passes = int(passes)
        self.dim = subvector_dim(size, c_dim)
        self.k_bit = int(k_bit)
        self.n_bit = int(n_bit)
        self.K = 2 ** self.k_bit if self.k_bit > 0 else self.dim
        self.M = size // self.dim
        self.random = bool(random)
        # False: the row-major kernels and the raw codebook (gqx/compress/
        # vq.py:99-105)
        self.flat_ok = supports_flat(self.dim, self.K)

        if codebook is None:
            if self.K == self.dim:
                codebook = orthonormal_codebook(self.dim, seed=codebook_seed)
            else:
                codebook = get_codebook(self.dim, self.K)
        if codebook.shape != (self.K, self.dim):
            raise ValueError(f"codebook shape {codebook.shape} != {(self.K, self.dim)}")
        codebook = np.ascontiguousarray(codebook, dtype=np.float32)
        self.codewords = torch.from_numpy(
            bf16_exact_codebook(codebook) if self.flat_ok else codebook)
        self._codewords_on: Dict[torch.device, torch.Tensor] = {}

        self.compressed_norm = self.n_bit != 32
        self.norm_compressor = (
            ProbabilisticScalarCompressor(
                self.M, (self.M,), self.n_bit, random,
                segment_sizes=norm_segment_sizes,
            )
            if self.compressed_norm
            else None
        )

    def codebook(self, device) -> torch.Tensor:
        """The (K, dim) float32 codebook on ``device``: bf16-exact when
        ``flat_ok``, raw otherwise."""
        device = torch.device(device)
        cb = self._codewords_on.get(device)
        if cb is None:
            cb = self.codewords.to(device).contiguous()
            self._codewords_on[device] = cb
        return cb

    @property
    def code_dtype(self) -> torch.dtype:
        return code_dtype(self.code_bits)

    def _enc_input(self, vecs):
        """passes=1 rounds to bf16 in the kernel, so a bf16 input is taken as
        it is; anything else is float32."""
        if self.passes == 1 and vecs.dtype == torch.bfloat16:
            return vecs.contiguous()
        return vecs.to(torch.float32).contiguous()

    # -- encode -------------------------------------------------------------
    def compress_batch(self, vecs: torch.Tensor, generator=None) -> Sig:
        """vecs (U, size) -> {"codes": (U, M), "u": norm signature}; one
        encode launch and one uniform launch cover every user."""
        users = vecs.shape[0]
        if self.flat_ok:
            x = self._enc_input(vecs.reshape(users, -1))
            u, codes = hsq_ops.hsq_encode_flat(
                x, self.codebook(x.device), self.dim, self.passes, self.code_dtype)
        else:
            # the row-major encode reads bf16 rows as they are, anything
            # else as float32
            rows = vecs.reshape(users, self.M, self.dim)
            if rows.dtype != torch.bfloat16:
                rows = rows.to(torch.float32)
            rows = rows.contiguous()
            u, codes = hsq_rows.hsq_encode(rows, self.codebook(rows.device), self.code_dtype)
        sig: Sig = {"codes": codes}
        sig["u"] = self.norm_compressor.compress(u, generator) if self.compressed_norm else u
        return sig

    def compress(self, vec, generator=None) -> Sig:
        sig = self.compress_batch(vec.reshape(1, -1), generator)
        return {k: _index0(v) for k, v in sig.items()}

    # -- decode -------------------------------------------------------------
    def _u(self, sig: Sig) -> torch.Tensor:
        if self.compressed_norm:
            return self.norm_compressor.decompress(sig["u"])
        return sig["u"]

    def _decode(self, sig: Sig) -> torch.Tensor:
        """codes/u (..., M) -> (..., size), one launch for every user."""
        codes, u = sig["codes"].contiguous(), self._u(sig).contiguous()
        if self.flat_ok:
            return hsq_ops.hsq_decode_flat(codes, u, self.codebook(u.device),
                                           self.dim, self.passes)
        rows = hsq_rows.hsq_decode(codes, u, self.codebook(u.device))
        return rows.reshape(codes.shape[:-1] + (self.size,))

    def decompress(self, sig: Sig) -> torch.Tensor:
        return self._decode(sig).reshape(self.shape)

    def decompress_batch(self, sig: Sig) -> torch.Tensor:
        return self._decode(sig).reshape((sig["codes"].shape[0],) + self.shape)

    def decode_mean(self, sig: Sig) -> torch.Tensor:
        """PS server reduce.  Flat layout: the fused kernel decodes the U
        users' signatures once.  Row-major: per-user decode, then the mean."""
        if not self.flat_ok:
            return super().decode_mean(sig)
        u = self._u(sig).contiguous()
        return hsq_ops.hsq_decode_mean(
            sig["codes"].contiguous(), u, self.codebook(u.device), self.dim,
            self.passes,
        ).reshape(self.shape)

    @property
    def code_bits(self) -> int:
        """Physical bits per code = ceil(log2(K))."""
        return max((self.K - 1).bit_length(), 1)

    @property
    def wire_bits(self) -> int:
        norm_bits = (
            (2 * 32 * self.norm_compressor.n_segments + self.n_bit * self.M)
            if self.compressed_norm else 32 * self.M
        )
        return self.code_bits * self.M + norm_bits


def _index0(v):
    if isinstance(v, dict):
        return {k: _index0(x) for k, x in v.items()}
    return v[0]
