"""Compressor registry (counterpart of ``gqx/compress/__init__.py``).

This slice of the port has ``hsq`` and ``sgd``; the other names of gqx's
registry raise until their port lands (ROADMAP Queue 1, item 7).
"""

from __future__ import annotations

from typing import Tuple

from gqx_torch.compress.api import Compressor, Sig, subvector_dim  # noqa: F401
from gqx_torch.compress.scalar import (  # noqa: F401
    IdenticalCompressor,
    ProbabilisticScalarCompressor,
)
from gqx_torch.compress.vq import HSQCompressor  # noqa: F401

_NOT_PORTED = ("qsgd", "terngrad", "sign", "topk", "pvq", "residual", "maurey")


def make_compressor(name: str, size: int, shape: Tuple[int, ...], config,
                    norm_segment_sizes=None) -> Compressor:
    """One compressor from a GQConfig-like object; ``norm_segment_sizes``
    segments HSQ's norm range per original leaf of a grouped unit."""
    if name == "sgd":
        return IdenticalCompressor(size, shape)
    if name == "hsq":
        return HSQCompressor(
            size, shape, config.c_dim, config.k_bit, config.n_bit,
            bool(getattr(config, "random", True)),
            norm_segment_sizes=norm_segment_sizes,
            passes=int(getattr(config, "hsq_passes", 2)),
        )
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"compressor {name!r} is not ported yet (ROADMAP Queue 1, item 7)")
    raise ValueError(f"unknown compressor {name!r}")
