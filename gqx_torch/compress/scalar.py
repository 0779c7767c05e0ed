"""Scalar compressors (counterpart of ``gqx/compress/scalar.py``): identity,
SignSGD, QSGD (TernGrad is QSGD with ``n_bit=1`` and a whole-tensor bucket)
and the min/max probabilistic scalar quantizer that HSQ uses for its
per-subvector norms.

Every compressor works on the last axis, so a leading users axis needs
nothing more: the batched calls are the single-vector ones.

Only the m-order layout is ported: ``TransposedScalarCompressor`` exists in
gqx to avoid TPU lane padding and gives the same ranges and levels.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from gqx_torch.compress.api import Compressor, Sig, stochastic_increment, subvector_dim


class IdenticalCompressor(Compressor):
    """No-op; also the passthrough for small (<= 1000 element) leaves
    (reference ps_quantizer.py:17-20)."""

    def compress(self, vec, generator=None) -> Sig:
        return {"vec": vec}

    def decompress(self, sig) -> torch.Tensor:
        return sig["vec"]

    def compress_batch(self, vecs, generator=None) -> Sig:
        return {"vec": vecs}

    def decompress_batch(self, sig) -> torch.Tensor:
        return sig["vec"]

    @property
    def wire_bits(self) -> int:
        return 32 * self.size


class SignSGDCompressor(Compressor):
    """sign(v) with 0 preserved; decompress is the identity (reference
    signsgd_compressor.py:8-12).  The PS mean of the users' signs is then a
    majority vote with ties preserved."""

    def compress(self, vec, generator=None) -> Sig:
        return {"signs": torch.sign(vec)}

    def decompress(self, sig) -> torch.Tensor:
        return sig["signs"]

    compress_batch = compress
    decompress_batch = decompress

    @property
    def wire_bits(self) -> int:
        return self.size  # 1 bit per coordinate


class QSGDCompressor(Compressor):
    """Bucketed stochastic scalar quantization (reference
    qsgd_compressor.py:42-71; gqx/compress/scalar.py:264-321).

    Per bucket of ``dim`` coordinates: norm = max |v|, scaled = |v / norm| *
    s with s = 2^n_bit, l = clamp(scaled, 0, s - 1) truncated, then l +=
    (scaled - l > U) (so l may reach s), signs = v > 0.  decompress: l *
    (2*signs - 1) * norm / s.  A zero bucket divides by 1 instead of 0 (the
    reference gives NaN), so all-zero gradients round-trip to zero.  The op
    order is gqx's, so the levels with ``random=False`` are bit-equal."""

    def __init__(self, size: int, shape: Tuple[int, ...], n_bit: int, c_dim: int,
                 random: bool = True):
        super().__init__(size, shape)
        self.n_bit = int(n_bit)
        self.s = 2 ** int(n_bit)
        self.random = bool(random)
        self.dim = subvector_dim(size, c_dim)
        self.M = size // self.dim

    def compress(self, vec, generator=None) -> Sig:
        lead = tuple(vec.shape[:vec.dim() - len(self.shape)])
        rows = vec.reshape(lead + (self.M, self.dim))
        norm = rows.abs().amax(-1)
        safe_norm = torch.where(norm == 0.0, torch.ones_like(norm), norm)
        scaled = torch.abs(rows / safe_norm[..., None]) * self.s
        l = torch.clamp(scaled, 0, self.s - 1).to(torch.int32)
        if self.random:
            if generator is None:
                raise ValueError("stochastic rounding needs a generator")
            l = l + stochastic_increment(scaled, l, generator)
        return {"norm": norm, "signs": (rows > 0).reshape(vec.shape), "l": l.reshape(vec.shape)}

    def decompress(self, sig) -> torch.Tensor:
        l = sig["l"]
        lead = tuple(l.shape[:l.dim() - len(self.shape)])
        scaled = l.to(torch.float32) * (2.0 * sig["signs"].to(torch.float32) - 1.0)
        out = scaled.reshape(lead + (self.M, self.dim)) * sig["norm"][..., None] / self.s
        return out.reshape(l.shape)

    compress_batch = compress
    decompress_batch = decompress

    @property
    def wire_bits(self) -> int:
        # 1 sign + n_bit level per coordinate + a 32-bit norm per bucket
        return self.size * (1 + self.n_bit) + 32 * self.M


_CHUNK = 1024  # rows per first-stage block of the segmented min/max


class _SegmentPlan:
    """Static index plan for the per-segment min/max of a (U, M) tensor in
    two batched gathers + reductions.

    Stage 1 cuts every segment into blocks of ``_CHUNK`` rows, topping up a
    segment's last block with copies of its own first row (a copy changes
    no min or max), and reduces each block.  Stage 2 does the same with the
    block results of each segment.  Every launch covers all users and all
    segments, so a ResNet-50 unit's ~77 segments cost a handful of launches
    instead of one per segment and user.  ``torch.segment_reduce`` gives the
    same bounds but took ~150x longer on an H100 at that unit's shape
    (``python -m gqx_torch.scripts.segment_bounds``; PERF.md)."""

    def __init__(self, segment_sizes: Tuple[int, ...], device: torch.device):
        idx1, blocks_per_seg, off = [], [], 0
        for n in segment_sizes:
            nb = -(-n // _CHUNK)
            rows = torch.arange(off, off + n)
            pad = nb * _CHUNK - n
            if pad:
                rows = torch.cat([rows, rows.new_full((pad,), off)])
            idx1.append(rows)
            blocks_per_seg.append(nb)
            off += n
        width = max(blocks_per_seg)
        idx2, boff = [], 0
        for nb in blocks_per_seg:
            cols = torch.arange(boff, boff + nb)
            if nb < width:
                cols = torch.cat([cols, cols.new_full((width - nb,), boff)])
            idx2.append(cols)
            boff += nb
        self.idx1 = torch.cat(idx1).to(device)
        self.idx2 = torch.cat(idx2).to(device)
        self.n_blocks = boff
        self.width = width
        self.n_segments = len(segment_sizes)
        self.lengths = torch.tensor(segment_sizes, dtype=torch.long, device=device)

    def bounds(self, vec: torch.Tensor):
        """vec (..., M) -> (lower, upper), each (..., n_segments)."""
        lead = vec.shape[:-1]
        blocks = vec.index_select(-1, self.idx1).reshape(lead + (self.n_blocks, _CHUNK))
        lo1, hi1 = torch.aminmax(blocks, dim=-1)
        shape2 = lead + (self.n_segments, self.width)
        lower = lo1.index_select(-1, self.idx2).reshape(shape2).amin(-1)
        upper = hi1.index_select(-1, self.idx2).reshape(shape2).amax(-1)
        return lower, upper

    def broadcast(self, per_seg: torch.Tensor, m: int) -> torch.Tensor:
        return torch.repeat_interleave(per_seg, self.lengths, dim=-1, output_size=m)


@functools.lru_cache(maxsize=64)
def _segment_plan(segment_sizes: Tuple[int, ...], device: torch.device) -> _SegmentPlan:
    return _SegmentPlan(segment_sizes, device)


class ProbabilisticScalarCompressor(Compressor):
    """Min/max-range stochastic scalar quantizer for HSQ's per-subvector
    norms (reference probabilistic_scalar_compressor.py:12-33).

    compress: lower/upper = min/max per segment; scaled =
    |(v - lower) / (upper - lower)| * s; l = clamp(scaled, 0, s-1) truncated;
    then l += (scaled - l > U).  decompress: l * (upper - lower) / s + lower.
    The op order is gqx's (gqx/compress/scalar.py:131-134, 153-154), so the
    levels with ``random=False`` are bit-equal.

    Works on the last axis: ``vec`` may carry a leading users axis, in
    which case one set of launches covers every user.  ``segment_sizes``
    computes the range per contiguous segment (per original leaf of a
    grouped unit)."""

    def __init__(self, size: int, shape: Tuple[int, ...], n_bit: int,
                 random: bool = True,
                 segment_sizes: Optional[Tuple[int, ...]] = None):
        super().__init__(size, shape)
        self.n_bit = int(n_bit)
        self.s = 2 ** int(n_bit)
        self.random = bool(random)
        self.segment_sizes = tuple(segment_sizes) if segment_sizes else None
        if self.segment_sizes:
            if sum(self.segment_sizes) != size:
                raise ValueError(f"segments {self.segment_sizes} do not sum to {size}")
            self.n_segments = len(self.segment_sizes)
        else:
            self.n_segments = 1

    def _bounds(self, vec):
        if self.segment_sizes is None:
            lower, upper = torch.aminmax(vec, dim=-1)
            return lower, upper, lower[..., None], upper[..., None]
        plan = _segment_plan(self.segment_sizes, vec.device)
        lower, upper = plan.bounds(vec)
        m = vec.shape[-1]
        return lower, upper, plan.broadcast(lower, m), plan.broadcast(upper, m)

    def compress(self, vec, generator=None) -> Sig:
        lower, upper, lo_e, up_e = self._bounds(vec)
        span = up_e - lo_e
        zero = span == 0.0
        scaled = torch.where(
            zero, torch.zeros((), dtype=vec.dtype, device=vec.device),
            torch.abs((vec - lo_e) / torch.where(zero, torch.ones_like(span), span)) * self.s,
        )
        l = torch.clamp(scaled, 0, self.s - 1).to(torch.int32)
        if self.random:
            if generator is None:
                raise ValueError("stochastic rounding needs a generator")
            l = l + stochastic_increment(scaled, l, generator)
        return {"lower": lower, "upper": upper, "l": l}

    def decompress(self, sig) -> torch.Tensor:
        lower, upper = sig["lower"], sig["upper"]
        m = sig["l"].shape[-1]
        if self.segment_sizes is not None:
            plan = _segment_plan(self.segment_sizes, sig["l"].device)
            lower = plan.broadcast(lower, m)
            upper = plan.broadcast(upper, m)
        else:
            lower, upper = lower[..., None], upper[..., None]
        span = upper - lower
        return sig["l"].to(torch.float32) * span / self.s + lower

    # both work on the last axis, so a users axis needs nothing more
    compress_batch = compress
    decompress_batch = decompress

    @property
    def wire_bits(self) -> int:
        return 2 * 32 * self.n_segments + self.n_bit * self.size
