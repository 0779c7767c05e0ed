"""ctypes binding of the port's host-side data pipeline (counterpart of
``gqx/data/native.py``): ``gqx_torch/csrc/gqx_native.cc``, built with g++
into ``gqx_torch/_build/`` at first use (``ops/_build.load_host``).

The library is gqx's native code built with gqx's flags, and each function
takes gqx's arguments, so the same inputs and the same ``rng`` state give
gqx's bits.  ``available()`` says whether it built and loaded; every entry
point raises where it did not.
"""

from __future__ import annotations

import ctypes
import functools
import subprocess
from typing import Optional

import numpy as np

from gqx_torch.data.transforms import AUGMENT, STATS
from gqx_torch.ops import _build

_MAX_CHANNELS = 8   # the library's per-channel tables


@functools.lru_cache(maxsize=None)
def _library() -> Optional[ctypes.CDLL]:
    try:
        lib = _build.load_host("gqx_native")
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return None
    lib.gqx_augment_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64,
    ]
    lib.gqx_augment_batch.restype = None
    lib.gqx_normalize_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.gqx_normalize_batch.restype = None
    for fn in (lib.gqx_pack_bits, lib.gqx_unpack_bits):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int]
        fn.restype = None
    lib.gqx_num_threads.argtypes = []
    lib.gqx_num_threads.restype = ctypes.c_int
    return lib


def available() -> bool:
    return _library() is not None


def _lib() -> ctypes.CDLL:
    lib = _library()
    if lib is None:
        raise RuntimeError("the native data library (gqx_torch/csrc/gqx_native.cc) did not "
                           "build: is g++ installed?")
    return lib


def num_threads() -> int:
    """The OpenMP threads the library's loops run on."""
    return int(_lib().gqx_num_threads())


def _images(x_uint8: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x_uint8)
    if x.dtype != np.uint8 or x.ndim != 4 or not 0 < x.shape[-1] <= _MAX_CHANNELS:
        raise ValueError(f"expected (n, h, w, c <= {_MAX_CHANNELS}) uint8 images, got "
                         f"{x.dtype} {x.shape}")
    return x


def _stats(dataset: str, channels: int):
    # the library reads the first ``channels`` of each
    mean, std = (np.asarray(s, np.float32) for s in STATS[dataset])
    if mean.shape[0] < channels:
        raise ValueError(f"{dataset} has {mean.shape[0]} channel statistics, the images "
                         f"{channels} channels")
    return mean, std


def augment_batch(x_uint8: np.ndarray, dataset: str, rng: np.random.Generator) -> np.ndarray:
    """Fused pad / random crop / flip / normalize of (n, h, w, c) uint8
    images into float32, as gqx's; one seed drawn from ``rng`` as gqx draws
    it (``rng.integers(0, 2**63 - 1)``) fixes every image's crop and flip."""
    x = _images(x_uint8)
    n, h, w, c = x.shape
    pad, flip = AUGMENT[dataset]
    mean, std = _stats(dataset, c)
    out = np.empty((n, h, w, c), np.float32)
    seed = int(rng.integers(0, 2 ** 63 - 1))
    _lib().gqx_augment_batch(x.ctypes.data, out.ctypes.data, n, h, w, c, pad, int(flip),
                             mean.ctypes.data, std.ctypes.data, seed)
    return out


def normalize_batch(x_uint8: np.ndarray, dataset: str) -> np.ndarray:
    """(x / 255 - mean) / std of uint8 images (..., c), as gqx's library
    computes it."""
    x = np.ascontiguousarray(x_uint8)
    if x.dtype != np.uint8 or x.ndim < 1 or not 0 < x.shape[-1] <= _MAX_CHANNELS:
        raise ValueError(f"expected (..., c <= {_MAX_CHANNELS}) uint8 values, got "
                         f"{x.dtype} {x.shape}")
    c = x.shape[-1]
    mean, std = _stats(dataset, c)
    out = np.empty(x.shape, np.float32)
    _lib().gqx_normalize_batch(x.ctypes.data, out.ctypes.data, x.size // c, c,
                               mean.ctypes.data, std.ctypes.data)
    return out


def _bits(bits: int) -> int:
    if not 1 <= int(bits) <= 32:
        raise ValueError(f"bits must be in [1, 32], got {bits}")
    return int(bits)


def pack_bits(values: np.ndarray, bits: int) -> np.ndarray:
    """n values of ``bits`` bits into ceil(n * bits / 32) uint32 words,
    little-endian within the stream."""
    bits = _bits(bits)
    v = np.ascontiguousarray(values, np.uint32).reshape(-1)
    n = v.shape[0]
    out = np.zeros(((n * bits + 31) // 32,), np.uint32)
    _lib().gqx_pack_bits(v.ctypes.data, out.ctypes.data, n, bits)
    return out


def unpack_bits(words: np.ndarray, bits: int, n: int) -> np.ndarray:
    """The first ``n`` values of ``bits`` bits of a word stream."""
    bits = _bits(bits)
    w = np.ascontiguousarray(words, np.uint32).reshape(-1)
    if w.shape[0] < (n * bits + 31) // 32:
        raise ValueError(f"{w.shape[0]} words hold fewer than {n} values of {bits} bits")
    out = np.empty((n,), np.uint32)
    _lib().gqx_unpack_bits(w.ctypes.data, out.ctypes.data, n, bits)
    return out
