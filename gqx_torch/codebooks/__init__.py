"""Codebook registry (counterpart of ``gqx/codebooks/__init__.py``).

Reads ``angular_dim_{d}_Ks_{K}.fvecs`` files in place and never writes them,
searching gqx's directories in gqx's order (``search_dirs``) and skipping a
file whose shape is not (K, d).  Rows are L2-normalized at load, as the
reference does.  Training a missing codebook with k-means is not ported
yet, so a codebook that no directory holds raises.
"""

from __future__ import annotations

import functools
import os
from typing import List, Optional

import numpy as np

from gqx_torch.utils.vecs_io import fvecs_read, normalize_rows

#: a directory searched after ``search_dir`` and before the repository's
ENV_DIR = "GQX_CODEBOOK_DIR"
#: a directory searched last (an external artifact family)
ENV_REFERENCE_DIR = "GQX_REFERENCE_CODEBOOKS"

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(_REPO_ROOT, "codebooks", "learned_codebook")
EXTRA_SEARCH_DIRS = ("./codebooks/learned_codebook",)


def codebook_filename(dim: int, k: int) -> str:
    return f"angular_dim_{dim}_Ks_{k}.fvecs"


def search_dirs(search_dir: Optional[str] = None) -> List[str]:
    """The directories searched, in order: ``search_dir``, ``$GQX_CODEBOOK_DIR``,
    the repository's ``codebooks/learned_codebook``, ``./codebooks/learned_codebook``
    and ``$GQX_REFERENCE_CODEBOOKS`` (an unset variable or a missing argument
    adds nothing)."""
    env, ref = os.environ.get(ENV_DIR), os.environ.get(ENV_REFERENCE_DIR)
    return [d for d in (search_dir, env, DEFAULT_DIR, *EXTRA_SEARCH_DIRS, ref) if d]


@functools.lru_cache(maxsize=None)
def get_codebook(dim: int, k: int, search_dir: Optional[str] = None) -> np.ndarray:
    """Unit-row (k, dim) float32 codebook: the first file of ``search_dirs``
    that holds a (k, dim) codebook."""
    dirs = search_dirs(search_dir)
    for d in dirs:
        path = os.path.join(d, codebook_filename(dim, k))
        if os.path.exists(path):
            cb = fvecs_read(path)
            if cb.shape == (k, dim):
                return normalize_rows(cb)[1].astype(np.float32)
    raise FileNotFoundError(
        f"no (K={k}, dim={dim}) codebook {codebook_filename(dim, k)} in {dirs}; training "
        "one with k-means is not ported yet (ROADMAP Queue 1, item 12)")


def orthonormal_codebook(dim: int, seed: int = 1) -> np.ndarray:
    """Random orthonormal (dim, dim) codebook for the K == dim case."""
    from scipy import stats

    return stats.ortho_group.rvs(dim, random_state=seed).astype(np.float32)
