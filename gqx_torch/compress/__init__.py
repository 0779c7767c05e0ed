"""Compressor registry (counterpart of ``gqx/compress/__init__.py``).

Every name of gqx's registry builds the port's counterpart of gqx's class:
``sgd``, ``sign``, ``qsgd``, ``terngrad``, ``hsq``, ``pvq``, ``residual``,
``topk`` and ``maurey``.
"""

from __future__ import annotations

from typing import Tuple

from gqx_torch.compress.api import Compressor, Sig, subvector_dim  # noqa: F401
from gqx_torch.compress.scalar import (  # noqa: F401
    IdenticalCompressor,
    ProbabilisticScalarCompressor,
    QSGDCompressor,
    SignSGDCompressor,
)
from gqx_torch.compress.sparse import (  # noqa: F401
    MaureySparsificationCompressor,
    TopKCompressor,
)
from gqx_torch.compress.vq import (  # noqa: F401
    HSQCompressor,
    ProbabilisticVectorCompressor,
    ResidualCompressor,
)


def make_compressor(name: str, size: int, shape: Tuple[int, ...], config,
                    norm_segment_sizes=None, device="cuda") -> Compressor:
    """One compressor from a GQConfig-like object; ``norm_segment_sizes``
    segments the VQ families' norm range per original leaf of a grouped
    unit; a VQ codebook that no file holds is trained on ``device``."""
    random = bool(getattr(config, "random", True))
    if name == "sgd":
        return IdenticalCompressor(size, shape)
    if name == "sign":
        return SignSGDCompressor(size, shape)
    if name == "qsgd":
        return QSGDCompressor(size, shape, config.n_bit, config.c_dim, random)
    if name == "terngrad":
        # QSGD with n_bit=1 and a whole-tensor bucket (reference README.md:21-26)
        return QSGDCompressor(size, shape, 1, 0, random)
    if name == "hsq":
        return HSQCompressor(
            size, shape, config.c_dim, config.k_bit, config.n_bit, random,
            norm_segment_sizes=norm_segment_sizes,
            passes=int(getattr(config, "hsq_passes", 2)),
            codebook_device=device,
        )
    if name == "pvq":
        return ProbabilisticVectorCompressor(
            size, shape, config.c_dim, config.k_bit, config.n_bit, random,
            norm_segment_sizes=norm_segment_sizes, codebook_device=device,
        )
    if name == "residual":
        # gqx's registry passes no ``passes`` here: its HSQ stage runs at 2
        return ResidualCompressor(
            size, shape, config.c_dim, config.k_bit, config.n_bit, random,
            norm_segment_sizes=norm_segment_sizes, codebook_device=device,
        )
    if name == "topk":
        return TopKCompressor(size, shape, config.cr)
    if name == "maurey":
        return MaureySparsificationCompressor(
            size, shape, config.c_dim, config.k_bit, config.n_bit
        )
    raise ValueError(f"unknown compressor {name!r}")
