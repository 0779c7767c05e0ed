"""Sparsifying compressors (counterpart of ``gqx/compress/sparse.py``): top-k
and Maurey sampling.

The signature is the sparse payload itself (values or signs and their
indices), so the packed wire is what is sent; decompress scatters back to
dense.  Both work on a leading users axis; both are per-leaf units, never
grouped (their budgets are per layer in the reference).
"""

from __future__ import annotations

from typing import Tuple

import torch

from gqx_torch.compress.api import Compressor, Sig, batch_uniform


class TopKCompressor(Compressor):
    """Keep the k = size // cr largest-|v| entries (reference
    topk_sparsification_compressor.py:15-16).

    The order is ``jax.lax.top_k``'s: |v| descending, equal |v| by the lowest
    index first.  ``torch.topk`` promises no order among ties, and gradients
    taken in bf16 and carried in float32 hold many, so the indices come from
    a stable descending sort of |v|."""

    in_order_mean = True

    def __init__(self, size: int, shape: Tuple[int, ...], cr: int):
        super().__init__(size, shape)
        self.cr = int(cr)
        # The reference's k is a plain floor division, so a tensor smaller
        # than cr keeps nothing.  As gqx does (its sparse.py:33-40), one slot
        # stays on the wire with the value 0, which decodes to the same zeros.
        self.dropped = size // self.cr == 0
        self.k = max(1, size // self.cr)

    def compress_batch(self, vecs: torch.Tensor, generator=None) -> Sig:
        """vecs (U, *shape) -> {"values": (U, k), "indices": (U, k) int32}."""
        flat = vecs.reshape(vecs.shape[0], -1)
        order = torch.sort(flat.abs(), dim=1, descending=True, stable=True).indices
        idx = order[:, :self.k]
        values = flat.gather(1, idx)
        if self.dropped:
            values = torch.zeros_like(values)
        return {"values": values, "indices": idx.to(torch.int32)}

    def decompress_batch(self, sig: Sig) -> torch.Tensor:
        values = sig["values"]
        out = values.new_zeros((values.shape[0], self.size))
        out.scatter_(1, sig["indices"].long(), values)
        return out.reshape((values.shape[0],) + self.shape)

    @property
    def wire_bits(self) -> int:
        return self.k * (32 + 32)  # a float32 value and an int32 index per entry


def maurey_cdf(flat: torch.Tensor):
    """(l1, cdf) of (U, size) rows, both float64: ||v||_1 and the
    cumulative sum of |v| / ||v||_1 (an all-zero row divides by 1).

    gqx sums in float32.  Over a layer of millions of entries a float32
    CDF moves by more than a slot between two summation orders (the CPU's
    and the card's), so most samples would land elsewhere; in float64 the
    two agree but where r meets a boundary.  Where every partial sum is
    exact in float32 the two precisions give the same codes."""
    a = flat.abs().to(torch.float64)
    l1 = a.sum(1)
    safe = torch.where(l1 == 0.0, torch.ones_like(l1), l1)
    return l1, torch.cumsum(a / safe[:, None], dim=1)


class MaureySparsificationCompressor(Compressor):
    """Maurey sampling (reference maurey_sparsification.py:4-50): k indices
    i.i.d. in proportion to |v| / ||v||_1, each sent with the sign of its
    coordinate, and scale = ||v||_1 / k; decompress adds the signs (a
    duplicate pick counts twice) and scales.

    Configuration (its :7-9): cr = 32*c_dim // (k_bit + n_bit), 16-bit
    indices up to 65,536 elements and 32-bit above, k = 32*size //
    ((idx_bits + 1) * cr), at least 1.  The uniforms come from
    ``gqx_torch.ops.rand.uniform`` (the Philox kernel on the card); gqx
    draws them with threefry.  The CDF is float64 (``maurey_cdf``)."""

    def __init__(self, size: int, shape: Tuple[int, ...], c_dim: int, k_bit: int,
                 n_bit: int):
        super().__init__(size, shape)
        self.cr = 32 * c_dim // (k_bit + n_bit)
        if self.cr == 0:
            # gqx divides by zero here (its sparse.py:78-80)
            raise ValueError(f"maurey: cr = 32*c_dim // (k_bit + n_bit) is 0 for c_dim={c_dim}, "
                             f"k_bit={k_bit}, n_bit={n_bit}")
        self.idx_bits = 32 if size > 65536 else 16
        self.k = max(1, 32 * size // ((self.idx_bits + 1) * self.cr))

    #: one draw: the samples' uniforms
    seed_draws = 1

    def sample(self, vecs: torch.Tensor, r: torch.Tensor) -> Sig:
        """vecs (U, *shape), r (U, k) uniforms -> the signature: each code is
        the first index whose CDF reaches its r, clipped to the last index;
        its sign may be 0 (an all-zero row)."""
        flat = vecs.reshape(vecs.shape[0], -1)
        l1, cdf = maurey_cdf(flat)
        codes = torch.searchsorted(cdf, r.to(torch.float64)).clamp(0, self.size - 1)
        return {"scale": l1.to(flat.dtype) / self.k, "codes": codes.to(torch.int32),
                "signs": torch.sign(flat.gather(1, codes))}

    def compress_batch(self, vecs: torch.Tensor, generator=None) -> Sig:
        """vecs (U, *shape) -> {"scale": (U,), "codes": (U, k) int32,
        "signs": (U, k)}; one uniform launch for every user."""
        if generator is None:
            raise ValueError("maurey samples its codes: it needs a generator")
        r = batch_uniform(generator, (vecs.shape[0], self.k), vecs.device)
        return self.sample(vecs, r)

    def decompress_batch(self, sig: Sig) -> torch.Tensor:
        signs = sig["signs"].to(torch.float32)
        out = signs.new_zeros((signs.shape[0], self.size))
        out.scatter_add_(1, sig["codes"].long(), signs)
        return (sig["scale"][:, None] * out).reshape((signs.shape[0],) + self.shape)

    @property
    def wire_bits(self) -> int:
        # a scale and (index + sign) per sample
        return 32 + self.k * (self.idx_bits + 1)
