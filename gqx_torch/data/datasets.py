"""Raw-format dataset readers (counterpart of ``gqx/data/datasets.py``; no
torchvision dependency, zero-download).

Covers the reference's six loaders (reference dataloaders.py:5-162):
mnist / cifar10 / cifar100 / stl10 / svhn / tinyimg, each returning in-memory
(images NHWC uint8, labels int64) splits, plus a deterministic ``synthetic``
dataset for tests/benchmarks on machines without the raw files.

Files are looked up under ``data_dir`` in the standard layouts
(``MNIST/raw/*-ubyte[.gz]``, ``cifar-10-batches-py/``, ``cifar-100-python/``,
``stl10_binary/``, ``*_32x32.mat``, ``tinyimgnet/{train,val}``).
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
from typing import Optional, Tuple

import numpy as np

Split = Tuple[np.ndarray, np.ndarray]  # (images NHWC uint8, labels int64)


def _maybe_gz_open(path):
    if os.path.exists(path):
        return open(path, "rb")
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    raise FileNotFoundError(path)


def _read_idx(path) -> np.ndarray:
    with _maybe_gz_open(path) as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(shape)


def _find(data_dir, *candidates):
    for c in candidates:
        p = os.path.join(data_dir, c)
        if os.path.exists(p) or os.path.exists(p + ".gz"):
            return p
    raise FileNotFoundError(f"none of {candidates} under {data_dir}")


def load_mnist(data_dir: str) -> Tuple[Split, Split]:
    def split(prefix):
        img = _read_idx(_find(data_dir, f"MNIST/raw/{prefix}-images-idx3-ubyte",
                              f"{prefix}-images-idx3-ubyte"))
        lbl = _read_idx(_find(data_dir, f"MNIST/raw/{prefix}-labels-idx1-ubyte",
                              f"{prefix}-labels-idx1-ubyte"))
        return img[..., None], lbl.astype(np.int64)

    return split("train"), split("t10k")


def _load_cifar_pickle(path):
    with open(path, "rb") as f:
        return pickle.load(f, encoding="latin1")


def load_cifar10(data_dir: str) -> Tuple[Split, Split]:
    root = os.path.join(data_dir, "cifar-10-batches-py")
    xs, ys = [], []
    for i in range(1, 6):
        d = _load_cifar_pickle(os.path.join(root, f"data_batch_{i}"))
        xs.append(d["data"])
        ys.extend(d["labels"])
    train_x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    d = _load_cifar_pickle(os.path.join(root, "test_batch"))
    test_x = d["data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return (
        (np.ascontiguousarray(train_x), np.asarray(ys, np.int64)),
        (np.ascontiguousarray(test_x), np.asarray(d["labels"], np.int64)),
    )


def load_cifar100(data_dir: str) -> Tuple[Split, Split]:
    root = os.path.join(data_dir, "cifar-100-python")

    def split(name):
        d = _load_cifar_pickle(os.path.join(root, name))
        x = d["data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return np.ascontiguousarray(x), np.asarray(d["fine_labels"], np.int64)

    return split("train"), split("test")


def load_svhn(data_dir: str) -> Tuple[Split, Split]:
    from scipy import io as sio

    def split(name):
        m = sio.loadmat(os.path.join(data_dir, f"{name}_32x32.mat"))
        x = np.transpose(m["X"], (3, 0, 1, 2))  # HWCN -> NHWC
        y = m["y"].reshape(-1).astype(np.int64) % 10  # label '10' means digit 0
        return np.ascontiguousarray(x), y

    return split("train"), split("test")


def load_stl10(data_dir: str) -> Tuple[Split, Split]:
    root = os.path.join(data_dir, "stl10_binary")

    def split(name):
        x = np.fromfile(os.path.join(root, f"{name}_X.bin"), dtype=np.uint8)
        x = x.reshape(-1, 3, 96, 96).transpose(0, 3, 2, 1)  # CWH -> NHWC
        y = np.fromfile(os.path.join(root, f"{name}_y.bin"), dtype=np.uint8)
        return np.ascontiguousarray(x), y.astype(np.int64) - 1

    return split("train"), split("test")


def load_tinyimagenet(data_dir: str, size: int = 64) -> Tuple[Split, Split]:
    """ImageFolder layout at data_dir/tinyimgnet/{train,val} (reference
    dataloaders.py:133-134).  Requires PIL."""
    from PIL import Image

    root = os.path.join(data_dir, "tinyimgnet")

    def split(name):
        base = os.path.join(root, name)
        classes = sorted(d for d in os.listdir(base) if os.path.isdir(os.path.join(base, d)))
        imgs, lbls = [], []
        for ci, cls in enumerate(classes):
            cdir = os.path.join(base, cls)
            for fn in sorted(os.listdir(cdir)):
                if not fn.lower().endswith((".jpg", ".jpeg", ".png")):
                    continue
                with Image.open(os.path.join(cdir, fn)) as im:
                    im = im.convert("RGB").resize((size, size))
                    imgs.append(np.asarray(im, np.uint8))
                lbls.append(ci)
        return np.stack(imgs), np.asarray(lbls, np.int64)

    return split("train"), split("val")


def load_digits_data(
    data_dir: str = "",
    image_size: int = 28,
    channels: int = 1,
    fold: Optional[Tuple[int, int]] = None,
) -> Tuple[Split, Split]:
    """Real handwritten-digit images bundled with scikit-learn (UCI ML
    hand-written digits, 1797 samples, 10 classes, 8x8 grayscale) — the
    offline stand-in for MNIST when no raw MNIST files are present.
    Upscaled bilinearly to ``image_size`` (28 so the reference's 784-input
    FCN — reference models/fcn.py:5-24 — applies unchanged; 32 with
    ``channels=3`` for the CIFAR-shaped conv models).

    Splits (always over the same deterministic rng(0) shuffle of all 1797):
      - ``fold=None``: legacy fixed 1500 train / 297 test split;
      - ``fold=(k, i)``: k-fold cross-validation — test = block i of size
        1797//k, train = the rest.  Over i=0..k-1 every sample is tested
        exactly once, giving parity studies the full 1797-sample power."""
    from PIL import Image
    from sklearn.datasets import load_digits as _sk_digits

    d = _sk_digits()
    imgs8 = (d.images / 16.0 * 255.0).astype(np.uint8)  # (1797, 8, 8)
    up = np.stack([
        np.asarray(Image.fromarray(im).resize((image_size, image_size), Image.BILINEAR))
        for im in imgs8
    ])
    y = d.target.astype(np.int64)
    order = np.random.default_rng(0).permutation(len(up))
    up, y = up[order][..., None], y[order]
    if channels > 1:
        up = np.repeat(up, channels, axis=-1)
    if fold is None:
        n_train = 1500
        return (up[:n_train], y[:n_train]), (up[n_train:], y[n_train:])
    k, i = fold
    assert 0 <= i < k, fold
    block = len(up) // k
    lo, hi = i * block, (i + 1) * block if i < k - 1 else len(up)
    test_idx = np.arange(lo, hi)
    train_idx = np.concatenate([np.arange(0, lo), np.arange(hi, len(up))])
    return (up[train_idx], y[train_idx]), (up[test_idx], y[test_idx])


def load_digits32_data(data_dir: str = "", fold=None) -> Tuple[Split, Split]:
    """Digits upscaled to 32x32x3: real image data in the CIFAR input shape,
    so the conv/BatchNorm model families (resnet*/vgg*/dense) can be trained
    to convergence offline (reference models/resnet.py:68-100 expect 3-channel
    32x32 input)."""
    return load_digits_data(data_dir, image_size=32, channels=3, fold=fold)


def load_synthetic(
    data_dir: str = "",
    num_train: int = 4096,
    num_test: int = 1024,
    image_shape=(32, 32, 3),
    num_classes: int = 10,
    seed: int = 0,
) -> Tuple[Split, Split]:
    """Deterministic class-structured random images: each class has a fixed
    template + noise, so simple models can actually learn (used by tests and
    benchmarks when no raw data is present)."""
    rng = np.random.default_rng(seed)
    templates = rng.integers(0, 256, size=(num_classes,) + image_shape)

    def split(n, s):
        r = np.random.default_rng(s)
        y = r.integers(0, num_classes, size=n)
        noise = r.normal(0, 32, size=(n,) + image_shape)
        x = np.clip(templates[y] * 0.5 + 64 + noise, 0, 255).astype(np.uint8)
        return x, y.astype(np.int64)

    return split(num_train, seed + 1), split(num_test, seed + 2)


LOADERS = {
    "mnist": load_mnist,
    "cifar10": load_cifar10,
    "cifar100": load_cifar100,
    "stl10": load_stl10,
    "svhn": load_svhn,
    "tinyimg": load_tinyimagenet,
    "synthetic": load_synthetic,
    "digits": load_digits_data,
    "digits32": load_digits32_data,
}


def load_dataset(name: str, data_dir: str, **kwargs) -> Tuple[Split, Split]:
    if name not in LOADERS:
        raise ValueError(f"unknown dataset {name!r}")
    return LOADERS[name](data_dir, **kwargs)
