"""Codebook registry (counterpart of ``gqx/codebooks/__init__.py``): load a
learned codebook from disk, or train one with k-means and cache it.

Reads ``angular_dim_{d}_Ks_{K}.fvecs`` files in place, searching gqx's
directories in gqx's order with the port's own cache after the
repository's codebooks (``search_dirs``), and skips a file whose shape is
not (K, d).  Where no directory holds the codebook, ``get_codebook`` trains
one on its ``device`` (``gqx_torch.codebooks.kmeans``) and writes it into
``CACHE_DIR`` only: unlike gqx, which caches into the repository's
``codebooks/learned_codebook``, the port never writes the shipped
codebooks.  Rows are L2-normalized at load and after training, as the
reference does.

Under an open process group of several ranks (the distributed backend),
rank 0 alone finds or trains a codebook and broadcasts it, so every rank
encodes and decodes with the same bytes: k-means on the card differs from
run to run in its last bits (``index_add_``'s atomics).  Every rank asks
for the same codebooks in the same order, as it builds the same plan.
"""

from __future__ import annotations

import functools
import os
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from gqx_torch.codebooks.kmeans import DEFAULT_TRAIN_SIZE, train_codebook
from gqx_torch.utils.vecs_io import fvecs_read, fvecs_write, normalize_rows

#: a directory searched after ``search_dir`` and before the repository's
ENV_DIR = "GQX_CODEBOOK_DIR"
#: a directory searched last (an external artifact family)
ENV_REFERENCE_DIR = "GQX_REFERENCE_CODEBOOKS"
#: the number of samples a missing codebook is trained on
ENV_TRAIN_SIZE = "GQX_CODEBOOK_TRAIN_SIZE"

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_ROOT = os.path.dirname(_PKG)
DEFAULT_DIR = os.path.join(_REPO_ROOT, "codebooks", "learned_codebook")
#: where the port writes the codebooks it trains (git-ignored)
CACHE_DIR = os.path.join(_PKG, "_build", "codebooks")
EXTRA_SEARCH_DIRS = ("./codebooks/learned_codebook",)


def codebook_filename(dim: int, k: int) -> str:
    return f"angular_dim_{dim}_Ks_{k}.fvecs"


def search_dirs(search_dir: Optional[str] = None) -> List[str]:
    """The directories searched, in order: ``search_dir``, ``$GQX_CODEBOOK_DIR``,
    the repository's ``codebooks/learned_codebook``, the port's ``CACHE_DIR``,
    ``./codebooks/learned_codebook`` and ``$GQX_REFERENCE_CODEBOOKS`` (an
    unset variable or a missing argument adds nothing)."""
    env, ref = os.environ.get(ENV_DIR), os.environ.get(ENV_REFERENCE_DIR)
    return [d for d in (search_dir, env, DEFAULT_DIR, CACHE_DIR, *EXTRA_SEARCH_DIRS, ref) if d]


@functools.lru_cache(maxsize=None)
def get_codebook(dim: int, k: int, search_dir: Optional[str] = None,
                 device="cuda") -> np.ndarray:
    """Unit-row (k, dim) float32 codebook: the first file of ``search_dirs``
    that holds a (k, dim) codebook, else one trained on ``device`` from
    ``$GQX_CODEBOOK_TRAIN_SIZE`` samples (else 1M) and written into
    ``CACHE_DIR``.  With several ranks, rank 0's, broadcast."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return _find_or_train(dim, k, search_dir, device)
    # the group's backend says where its tensors live: NCCL's on the card
    on = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    if dist.get_rank() == 0:
        cb = torch.from_numpy(_find_or_train(dim, k, search_dir, device)).to(on)
    else:
        cb = torch.empty((k, dim), dtype=torch.float32, device=on)
    dist.broadcast(cb, 0)
    return cb.cpu().numpy()


def _find_or_train(dim: int, k: int, search_dir: Optional[str], device) -> np.ndarray:
    fname = codebook_filename(dim, k)
    for d in search_dirs(search_dir):
        path = os.path.join(d, fname)
        if os.path.exists(path):
            cb = fvecs_read(path)
            if cb.shape == (k, dim):
                return normalize_rows(cb)[1].astype(np.float32)
    train_size = int(os.environ.get(ENV_TRAIN_SIZE, DEFAULT_TRAIN_SIZE))
    cb = normalize_rows(train_codebook(dim, k, train_size=train_size, device=device))[1]
    cb = cb.astype(np.float32)
    os.makedirs(CACHE_DIR, exist_ok=True)
    path = os.path.join(CACHE_DIR, fname)
    # a whole file or none: processes that train the same codebook race
    tmp = f"{path}.{os.getpid()}.tmp"
    fvecs_write(tmp, cb)
    os.replace(tmp, path)
    return cb


def orthonormal_codebook(dim: int, seed: int = 1) -> np.ndarray:
    """Random orthonormal (dim, dim) codebook for the K == dim case."""
    from scipy import stats

    return stats.ortho_group.rvs(dim, random_state=seed).astype(np.float32)
