"""fvecs/ivecs/bvecs codebook file IO (counterpart of ``gqx/utils/vecs_io.py``).

Each row is a little-endian int32 dimension header followed by ``dim``
payload elements: float32 for fvecs, int32 for ivecs, uint8 for bvecs.
Single-shot numpy buffer reshapes, no per-row loops.  An empty file reads
as a (0, 0) array.  The mmap readers return read-only views whose pages
are read on access; the writers truncate, or with ``append=True`` append.
"""

from __future__ import annotations

import os

import numpy as np


def ivecs_read(path) -> np.ndarray:
    raw = np.fromfile(path, dtype=np.int32)
    if raw.size == 0:
        return np.zeros((0, 0), dtype=np.int32)
    dim = int(raw[0])
    return np.ascontiguousarray(raw.reshape(-1, dim + 1)[:, 1:])


def fvecs_read(path) -> np.ndarray:
    return ivecs_read(path).view(np.float32)


def bvecs_read(path) -> np.ndarray:
    raw = np.fromfile(path, dtype=np.uint8)
    if raw.size == 0:
        return np.zeros((0, 0), dtype=np.uint8)
    dim = int(raw[:4].view(np.int32)[0])
    return np.ascontiguousarray(raw.reshape(-1, dim + 4)[:, 4:])


def ivecs_read_mmap(path) -> np.ndarray:
    # np.memmap refuses an empty file: the eager readers' (0, 0) result
    if os.path.getsize(path) == 0:
        return np.zeros((0, 0), dtype=np.int32)
    raw = np.memmap(path, dtype=np.int32, mode="r")
    dim = int(raw[0])
    return raw.reshape(-1, dim + 1)[:, 1:]


def fvecs_read_mmap(path) -> np.ndarray:
    return ivecs_read_mmap(path).view(np.float32)


def bvecs_read_mmap(path) -> np.ndarray:
    if os.path.getsize(path) == 0:
        return np.zeros((0, 0), dtype=np.uint8)
    raw = np.memmap(path, dtype=np.uint8, mode="r")
    dim = int(raw[:4].view(np.int32)[0])
    return raw.reshape(-1, dim + 4)[:, 4:]


def _write(path, buf: np.ndarray, append: bool) -> None:
    with open(path, "ab" if append else "wb") as f:
        buf.tofile(f)


def fvecs_write(path, vecs: np.ndarray, append: bool = False) -> None:
    vecs = np.ascontiguousarray(np.asarray(vecs, dtype=np.float32))
    ivecs_write(path, vecs.view(np.int32), append)


def ivecs_write(path, vecs: np.ndarray, append: bool = False) -> None:
    vecs = np.ascontiguousarray(np.asarray(vecs, dtype=np.int32))
    n, dim = vecs.shape
    buf = np.empty((n, dim + 1), dtype=np.int32)
    buf[:, 0] = dim
    buf[:, 1:] = vecs
    _write(path, buf, append)


def bvecs_write(path, vecs: np.ndarray, append: bool = False) -> None:
    vecs = np.ascontiguousarray(np.asarray(vecs, dtype=np.uint8))
    n, dim = vecs.shape
    buf = np.empty((n, dim + 4), dtype=np.uint8)
    buf[:, :4] = np.full((n, 1), dim, dtype=np.int32).view(np.uint8)
    buf[:, 4:] = vecs
    _write(path, buf, append)


def normalize_rows(vecs: np.ndarray):
    """L2-normalize rows with a divide-by-zero guard; returns (norms, unit_rows)."""
    vecs = np.asarray(vecs)
    norms = np.linalg.norm(vecs, axis=1)
    safe = np.where(norms == 0, 1.0, norms)
    return norms, (vecs / safe[:, None]).astype(vecs.dtype)
