"""k-means codebook training (counterpart of ``gqx/codebooks/kmeans.py``).

The reference's offline pipeline (its codebook_generator.py:14-20: 1M
unit-normalized N(0, 1) samples, scipy ``kmeans2`` with 20 iterations,
``minit='points'``) on the entry point's device.  The assignment is an
(N, dim) x (dim, K) float32 product, chunked over N so the logits stay
bounded for large K; the centroid update is float32 segment sums.

Departures from gqx by design:
  - the samples and the initial rows come from a ``torch.Generator``
    (``torch.randn``, ``torch.randperm``), not threefry, so one seed gives
    another codebook of the same quality;
  - no ``dim_pad``: gqx pads the samples with zero columns only so that one
    XLA compile serves a family of dims; in exact arithmetic the padding
    changes nothing;
  - the last chunk is shorter instead of padded with weight-0 rows, which
    add exact zeros to gqx's sums and counts.
"""

from __future__ import annotations

import numpy as np
import torch

from gqx_torch import resolve_device

DEFAULT_TRAIN_SIZE = 1_000_000
DEFAULT_ITERS = 20
_CHUNK = 1 << 17  # rows per assignment chunk


def unit_gaussian_samples(n: int, dim: int, generator: torch.Generator, device) -> torch.Tensor:
    """(n, dim) float32 N(0, 1) rows scaled to unit length; a zero row stays
    zero."""
    x = torch.randn((n, dim), generator=generator, dtype=torch.float32, device=device)
    norms = torch.linalg.vector_norm(x, dim=1, keepdim=True)
    return x / torch.where(norms == 0, 1.0, norms)


def _assign_chunk(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    # argmin ||x - c||^2 == argmax x.c - ||c||^2 / 2; argmax takes the first
    # index of the maximum, as jnp.argmax does
    logits = x @ centroids.T - 0.5 * (centroids * centroids).sum(1)
    return logits.argmax(1)


class _Float32Matmul:
    """Full float32 products on the card for the block (TF32 off, the flag
    restored after): with TF32 near-tie assignments would drift from the
    CPU's."""

    def __enter__(self):
        self._tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self._tf32


def assign(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Index (int64) of each row's nearest centroid, in chunks of ``_CHUNK``
    rows."""
    with _Float32Matmul():
        return torch.cat([_assign_chunk(x[s:s + _CHUNK], centroids)
                          for s in range(0, x.shape[0], _CHUNK)])


def lloyd_from(x: torch.Tensor, centroids: torch.Tensor, iters: int = DEFAULT_ITERS) -> torch.Tensor:
    """``iters`` Lloyd iterations on the (N, dim) float32 rows ``x`` from the
    (K, dim) ``centroids``; returns the new (K, dim) centroids.  Each
    iteration sums each chunk's rows and counts per centroid
    (``index_add_``) and adds them to the running totals, as gqx's scan
    does; a centroid no row chose keeps its value (scipy ``kmeans2``'s
    policy for an empty cluster)."""
    x = x.float()
    centroids = centroids.float().clone()
    k, dim = centroids.shape
    with _Float32Matmul():
        for _ in range(iters):
            sums = torch.zeros((k, dim), dtype=torch.float32, device=x.device)
            counts = torch.zeros((k,), dtype=torch.float32, device=x.device)
            for s in range(0, x.shape[0], _CHUNK):
                xc = x[s:s + _CHUNK]
                a = _assign_chunk(xc, centroids)
                sums += torch.zeros_like(sums).index_add_(0, a, xc)
                counts += torch.zeros_like(counts).index_add_(
                    0, a, torch.ones(a.shape[0], dtype=torch.float32, device=x.device))
            centroids = torch.where(counts[:, None] > 0,
                                    sums / torch.clamp(counts[:, None], min=1.0), centroids)
    return centroids


def train_codebook(dim: int, k: int, seed: int = 808, train_size: int = DEFAULT_TRAIN_SIZE,
                   iters: int = DEFAULT_ITERS, device="cuda") -> np.ndarray:
    """Train a (k, dim) float32 angular codebook on ``device`` (the reference's
    codebook_generator.py:23-31 semantics): a generator seeded with
    ``seed`` draws ``train_size`` unit Gaussian samples, then the ``k``
    distinct initial rows (``randperm(n)[:k]``), and Lloyd runs ``iters``
    iterations.  ``device="cuda"`` raises where there is no card."""
    dev = resolve_device(device)
    generator = torch.Generator(device=dev).manual_seed(seed)
    x = unit_gaussian_samples(train_size, dim, generator, dev)
    init = torch.randperm(train_size, generator=generator, device=dev)[:k]
    return lloyd_from(x, x[init], iters).cpu().numpy()
