"""Vector-quantization compressors (counterpart of ``gqx/compress/vq.py``):
HSQ nearest-neighbor, probabilistic VQ (PVQ) and the two-stage residual VQ.

HSQ compress (reference nearest_neighbor_compressor.py:63-78): view as
(M, dim) rows; p = rows @ codebook^T; code and signed scale u by the TPU
kernel's selection; u is then quantized by the min/max scalar quantizer.
decompress (its :80-90): codebook[code] * u.

The port always runs HSQ in the configuration gqx runs with
``use_pallas=True``.  Inside the flat-layout kernels' envelope
(``supports_flat(dim, K)``) that is the bf16-exact codebook and the
arithmetic of ``gqx_torch.ops.hsq``; outside it (a large K, a ragged dim) it
is the raw float32 codebook and the row-major kernels of
``gqx_torch.ops.hsq_rows``, as in gqx.

PVQ (reference probabilistic_vector_compressor.py:42-65) projects each row
with the codebook's pseudo-inverse, samples a code in proportion to |p| and
sends sign(p[code]) * ||p||_1; it decodes through the row-major decode with
the raw codebook.  Residual (reference residual_compressor.py:15-32) is HSQ,
then PVQ on what HSQ left.

Signatures are m-order: codes (U, M), u the norm quantizer's signature.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from gqx_torch.codebooks import get_codebook, orthonormal_codebook
from gqx_torch.compress.api import (Compressor, Sig, code_dtype, draw_seed,
                                    subvector_dim)
from gqx_torch.compress.scalar import ProbabilisticScalarCompressor
from gqx_torch.ops import hsq as hsq_ops
from gqx_torch.ops import hsq_rows
from gqx_torch.ops.hsq_prep import bf16_exact_codebook, supports_flat
from gqx_torch.ops.rand import uniform


class _VectorQuantizer(Compressor):
    """What HSQ and PVQ share: the (M, dim) subvector grid, a (K, dim)
    codebook (a file's, one trained on ``codebook_device`` where no file
    holds it, or an orthonormal one where K == dim) and the min/max
    quantizer of the per-subvector scales u."""

    def __init__(self, size, shape, c_dim, k_bit, n_bit, random, codebook,
                 codebook_seed, norm_segment_sizes, codebook_device):
        super().__init__(size, shape)
        self.dim = subvector_dim(size, c_dim)
        self.k_bit = int(k_bit)
        self.n_bit = int(n_bit)
        self.K = 2 ** self.k_bit if self.k_bit > 0 else self.dim
        self.M = size // self.dim
        self.random = bool(random)
        if codebook is None:
            if self.K == self.dim:
                codebook = orthonormal_codebook(self.dim, seed=codebook_seed)
            else:
                codebook = get_codebook(self.dim, self.K, device=codebook_device)
        if codebook.shape != (self.K, self.dim):
            raise ValueError(f"codebook shape {codebook.shape} != {(self.K, self.dim)}")
        self.file_codebook = np.ascontiguousarray(codebook, dtype=np.float32)
        self._copies: Dict[Tuple[str, torch.device], torch.Tensor] = {}

        self.compressed_norm = self.n_bit != 32
        self.norm_compressor = (
            ProbabilisticScalarCompressor(
                self.M, (self.M,), self.n_bit, random,
                segment_sizes=norm_segment_sizes,
            )
            if self.compressed_norm
            else None
        )

    def _on(self, attr: str, device) -> torch.Tensor:
        """The tensor ``self.<attr>`` on ``device``, copied once."""
        key = (attr, torch.device(device))
        t = self._copies.get(key)
        if t is None:
            t = self._copies[key] = getattr(self, attr).to(key[1]).contiguous()
        return t

    def codebook(self, device) -> torch.Tensor:
        """The (K, dim) float32 codebook the encode and decode use, on
        ``device``."""
        return self._on("codewords", device)

    @property
    def code_bits(self) -> int:
        """Physical bits per code = ceil(log2(K))."""
        return max((self.K - 1).bit_length(), 1)

    @property
    def code_dtype(self) -> torch.dtype:
        return code_dtype(self.code_bits)

    def _sig(self, u, codes, generator) -> Sig:
        sig: Sig = {"codes": codes}
        sig["u"] = self.norm_compressor.compress(u, generator) if self.compressed_norm else u
        return sig

    def _u(self, sig: Sig) -> torch.Tensor:
        if self.compressed_norm:
            return self.norm_compressor.decompress(sig["u"])
        return sig["u"]

    def decompress_batch(self, sig: Sig) -> torch.Tensor:
        return self._decode(sig).reshape((sig["codes"].shape[0],) + self.shape)

    @property
    def wire_bits(self) -> int:
        # 2 range scalars per segment (per original leaf of a grouped unit)
        norm_bits = (
            (2 * 32 * self.norm_compressor.n_segments + self.n_bit * self.M)
            if self.compressed_norm else 32 * self.M
        )
        return self.code_bits * self.M + norm_bits


class HSQCompressor(_VectorQuantizer):
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
        codebook_device="cuda",
    ):
        if not (c_dim > 0 and k_bit >= 0 and n_bit > 0):
            raise ValueError(f"bad HSQ config c_dim={c_dim} k_bit={k_bit} n_bit={n_bit}")
        if passes not in (1, 2):
            raise ValueError(f"passes must be 1 or 2, got {passes}")
        super().__init__(size, shape, c_dim, k_bit, n_bit, random, codebook,
                         codebook_seed, norm_segment_sizes, codebook_device)
        self.passes = int(passes)
        # False: the row-major kernels and the raw codebook (gqx/compress/
        # vq.py:99-105)
        self.flat_ok = supports_flat(self.dim, self.K)
        self.codewords = torch.from_numpy(
            bf16_exact_codebook(self.file_codebook) if self.flat_ok else self.file_codebook)

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
        return self._sig(u, codes, generator)

    # -- decode -------------------------------------------------------------
    def _decode(self, sig: Sig) -> torch.Tensor:
        """codes/u (..., M) -> (..., size), one launch for every user."""
        codes, u = sig["codes"].contiguous(), self._u(sig).contiguous()
        if self.flat_ok:
            return hsq_ops.hsq_decode_flat(codes, u, self.codebook(u.device),
                                           self.dim, self.passes)
        rows = hsq_rows.hsq_decode(codes, u, self.codebook(u.device))
        return rows.reshape(codes.shape[:-1] + (self.size,))

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


def inverse_cdf_sample(prob: torch.Tensor, r: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """codes[i] = the first index j with cumsum(prob[i])[j] >= r[i] - eps,
    clipped to the last index (gqx/compress/vq.py:355-365).  prob (N, K),
    r (N,) -> (N,) int64."""
    cdf = torch.cumsum(prob, dim=-1)
    codes = (cdf < (r[..., None] - eps)).sum(-1)
    return codes.clamp(0, prob.shape[-1] - 1)


class ProbabilisticVectorCompressor(_VectorQuantizer):
    """Unbiased VQ: project with the codebook's pseudo-inverse, sample the
    code in proportion to |p| / ||p||_1, scale by sign(p[code]) * ||p||_1.

    The uniforms of the samples come from ``gqx_torch.ops.rand.uniform``
    (the Philox kernel on the card), seeded from the generator before the
    norm quantizer draws; gqx draws them with threefry."""

    in_order_mean = True

    #: rows per block of the encode: p, |p|, prob and the CDF of a block are
    #: each (rows, K) float32; a ResNet-50 unit of 8 users is 11.7M rows
    CHUNK_ROWS = 1 << 18

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
        codebook_device="cuda",
    ):
        if not (c_dim > 0 and k_bit > 0 and n_bit > 0):
            raise ValueError(f"bad PVQ config c_dim={c_dim} k_bit={k_bit} n_bit={n_bit}")
        super().__init__(size, shape, c_dim, k_bit, n_bit, random, codebook,
                         codebook_seed, norm_segment_sizes, codebook_device)
        self.codewords = torch.from_numpy(self.file_codebook)
        # c+ = pinv(C^T), in float64 and cast, as gqx builds it (its :408-410)
        self.c_dagger = torch.from_numpy(np.linalg.pinv(
            self.file_codebook.astype(np.float64).T).astype(np.float32))

    def encode(self, vecs: torch.Tensor, r: torch.Tensor):
        """vecs (U, size), r (U, M) uniforms -> (u, codes) of (U, M): the
        samples as a function of their uniforms."""
        users = vecs.shape[0]
        rows = vecs.reshape(users * self.M, self.dim).to(torch.float32)
        r = r.reshape(-1)
        c_dagger_t = self._on("c_dagger", rows.device).t()
        n = rows.shape[0]
        u = torch.empty(n, dtype=torch.float32, device=rows.device)
        codes = torch.empty(n, dtype=self.code_dtype, device=rows.device)
        # gqx asks for Precision.HIGHEST (its :421-424): no TF32 on the card
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            for s in range(0, n, self.CHUNK_ROWS):
                p = rows[s:s + self.CHUNK_ROWS] @ c_dagger_t
                a = p.abs()
                l1 = a.sum(1)
                safe = torch.where(l1 == 0.0, torch.ones_like(l1), l1)
                idx = inverse_cdf_sample(a / safe[:, None], r[s:s + self.CHUNK_ROWS])
                selected = p.gather(1, idx[:, None])[:, 0]
                u[s:s + self.CHUNK_ROWS] = torch.sign(selected) * l1
                codes[s:s + self.CHUNK_ROWS] = idx.to(self.code_dtype)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        return u.reshape(users, self.M), codes.reshape(users, self.M)

    def compress_batch(self, vecs: torch.Tensor, generator=None) -> Sig:
        """vecs (U, size) -> {"codes": (U, M), "u": norm signature}; one
        uniform launch for the samples of every user."""
        if generator is None:
            raise ValueError("PVQ samples its codes: it needs a generator")
        users = vecs.shape[0]
        r = uniform(draw_seed(generator), 0, (users, self.M), vecs.device)
        u, codes = self.encode(vecs, r)
        return self._sig(u, codes, generator)

    def _decode(self, sig: Sig) -> torch.Tensor:
        codes, u = sig["codes"].contiguous(), self._u(sig).contiguous()
        rows = hsq_rows.hsq_decode(codes, u, self.codebook(u.device))
        return rows.reshape(codes.shape[:-1] + (self.size,))


class ResidualCompressor(Compressor):
    """Two-stage residual VQ: HSQ on the gradient, PVQ on the residual;
    decompression sums the stages.  The HSQ stage runs with ``passes=2``
    whatever ``hsq_passes`` says, as gqx's registry builds it."""

    in_order_mean = True

    def __init__(self, size, shape, c_dim, k_bit, n_bit, random=True,
                 norm_segment_sizes=None, codebook_device="cuda"):
        super().__init__(size, shape)
        self.stages = (
            HSQCompressor(size, shape, c_dim, k_bit, n_bit, random,
                          norm_segment_sizes=norm_segment_sizes, passes=2,
                          codebook_device=codebook_device),
            ProbabilisticVectorCompressor(size, shape, c_dim, k_bit, n_bit, random,
                                          norm_segment_sizes=norm_segment_sizes,
                                          codebook_device=codebook_device),
        )

    def compress_batch(self, vecs: torch.Tensor, generator=None) -> Sig:
        hsq, pvq = self.stages
        s0 = hsq.compress_batch(vecs, generator)
        residual = vecs - hsq.decompress_batch(s0)
        return {"stage0": s0, "stage1": pvq.compress_batch(residual, generator)}

    def decompress_batch(self, sig: Sig) -> torch.Tensor:
        hsq, pvq = self.stages
        return hsq.decompress_batch(sig["stage0"]) + pvq.decompress_batch(sig["stage1"])

    @property
    def wire_bits(self) -> int:
        return sum(s.wire_bits for s in self.stages)
