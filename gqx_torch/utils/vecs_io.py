"""fvecs codebook file reading (counterpart of ``gqx/utils/vecs_io.py``).

Each row is a little-endian int32 dimension header followed by ``dim``
float32 values."""

from __future__ import annotations

import numpy as np


def fvecs_read(path) -> np.ndarray:
    raw = np.fromfile(path, dtype=np.int32)
    if raw.size == 0:
        return np.zeros((0, 0), dtype=np.float32)
    dim = int(raw[0])
    return np.ascontiguousarray(raw.reshape(-1, dim + 1)[:, 1:]).view(np.float32)


def normalize_rows(vecs: np.ndarray):
    """L2-normalize rows with a divide-by-zero guard; returns (norms, unit_rows)."""
    vecs = np.asarray(vecs)
    norms = np.linalg.norm(vecs, axis=1)
    safe = np.where(norms == 0, 1.0, norms)
    return norms, (vecs / safe[:, None]).astype(vecs.dtype)
