"""Codebook registry (counterpart of ``gqx/codebooks/__init__.py``).

Reads the committed ``codebooks/learned_codebook/angular_dim_{d}_Ks_{K}.fvecs``
files in place and never writes them.  Rows are L2-normalized at load, as
the reference does.  Training a missing codebook with k-means is not
ported yet, so a missing file raises.
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import numpy as np

from gqx_torch.utils.vecs_io import fvecs_read, normalize_rows

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(_REPO_ROOT, "codebooks", "learned_codebook")


def codebook_filename(dim: int, k: int) -> str:
    return f"angular_dim_{dim}_Ks_{k}.fvecs"


@functools.lru_cache(maxsize=None)
def get_codebook(dim: int, k: int, search_dir: Optional[str] = None) -> np.ndarray:
    """Unit-row (k, dim) float32 codebook read from ``search_dir`` (default:
    the repository's ``codebooks/learned_codebook``)."""
    path = os.path.join(search_dir or DEFAULT_DIR, codebook_filename(dim, k))
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no codebook {path}; training one with k-means is not ported "
            "yet (ROADMAP Queue 1, item 12)")
    cb = fvecs_read(path)
    if cb.shape != (k, dim):
        raise ValueError(f"{path} holds shape {cb.shape}, expected {(k, dim)}")
    return normalize_rows(cb)[1].astype(np.float32)


def orthonormal_codebook(dim: int, seed: int = 1) -> np.ndarray:
    """Random orthonormal (dim, dim) codebook for the K == dim case."""
    from scipy import stats

    return stats.ortho_group.rvs(dim, random_state=seed).astype(np.float32)
