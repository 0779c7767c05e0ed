"""Vectorized host-side augmentation (numpy; counterpart of
``gqx/data/transforms.py``, the same bits from the same
``np.random.Generator``), matching the reference transform stacks
(reference dataloaders.py):

  - mnist: normalize (0.1307, 0.3081) only (its :8-18)
  - cifar10/cifar100/svhn: random crop with 4px padding + horizontal flip +
    CIFAR-10 channel stats (its :23-45 — the reference reuses CIFAR-10 stats
    for cifar100/svhn/stl10, which we preserve)
  - stl10: random crop 96 with 4px padding + flip, CIFAR-10 stats (its :77-90)
  - tinyimg: RandomResizedCrop(224) + flip + ImageNet stats for train
    (its :141-144, torchvision semantics: 10-attempt area/aspect sampling
    with center-crop fallback, bilinear resize); eval uses
    Resize(256) + CenterCrop(224) (its :154-155)
"""

from __future__ import annotations

import numpy as np

STATS = {
    "mnist": ((0.1307,), (0.3081,)),
    "cifar10": ((0.4914, 0.4822, 0.4465), (0.2023, 0.1994, 0.2010)),
    "cifar100": ((0.4914, 0.4822, 0.4465), (0.2023, 0.1994, 0.2010)),
    "stl10": ((0.4914, 0.4822, 0.4465), (0.2023, 0.1994, 0.2010)),
    "svhn": ((0.4914, 0.4822, 0.4465), (0.2023, 0.1994, 0.2010)),
    "tinyimg": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
    "synthetic": ((0.5, 0.5, 0.5), (0.25, 0.25, 0.25)),
    "digits": ((0.1307,), (0.3081,)),  # MNIST stats (stand-in dataset)
    "digits32": ((0.1307,) * 3, (0.3081,) * 3),
}

AUGMENT = {  # (random_crop_padding, horizontal_flip)
    "mnist": (0, False),
    "cifar10": (4, True),
    "cifar100": (4, True),
    "stl10": (4, True),
    "svhn": (4, True),
    "tinyimg": (4, True),
    "synthetic": (0, False),
    "digits": (0, False),
    # no crop/flip: keeps the conv-model parity comparison free of
    # augmentation randomness (and flips would corrupt digit identity)
    "digits32": (0, False),
}


def normalize(x_uint8: np.ndarray, dataset: str) -> np.ndarray:
    mean, std = STATS[dataset]
    x = x_uint8.astype(np.float32) / 255.0
    return (x - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def random_crop_flip(
    x: np.ndarray, rng: np.random.Generator, padding: int, flip: bool
) -> np.ndarray:
    """Random crop (after zero padding) + horizontal flip, vectorized over the
    batch with per-image offsets."""
    n, h, w, c = x.shape
    if padding > 0:
        padded = np.pad(x, ((0, 0), (padding, padding), (padding, padding), (0, 0)))
        off_h = rng.integers(0, 2 * padding + 1, size=n)
        off_w = rng.integers(0, 2 * padding + 1, size=n)
        rows = off_h[:, None] + np.arange(h)[None, :]            # (n, h)
        cols = off_w[:, None] + np.arange(w)[None, :]            # (n, w)
        x = padded[np.arange(n)[:, None, None], rows[:, :, None], cols[:, None, :], :]
    if flip:
        do = rng.random(n) < 0.5
        x = np.where(do[:, None, None, None], x[:, :, ::-1, :], x)
    return x


def _bilinear_crop_resize(
    x: np.ndarray, top, left, crop_h, crop_w, out_h: int, out_w: int
) -> np.ndarray:
    """Sample each image's (top, left, crop_h, crop_w) box to (out_h, out_w)
    with bilinear interpolation (half-pixel centers, torch align_corners=False
    semantics).  Box parameters are per-image arrays."""
    n, H, W, _ = x.shape
    top = np.asarray(top, np.float32).reshape(n, 1)
    left = np.asarray(left, np.float32).reshape(n, 1)
    crop_h = np.asarray(crop_h, np.float32).reshape(n, 1)
    crop_w = np.asarray(crop_w, np.float32).reshape(n, 1)
    ys = (np.arange(out_h, dtype=np.float32)[None, :] + 0.5) * (crop_h / out_h) - 0.5 + top
    xs = (np.arange(out_w, dtype=np.float32)[None, :] + 0.5) * (crop_w / out_w) - 0.5 + left
    y0f, x0f = np.floor(ys), np.floor(xs)
    wy = (ys - y0f).astype(np.float32)[:, :, None, None]
    wx = (xs - x0f).astype(np.float32)[:, None, :, None]
    y0 = np.clip(y0f.astype(np.int64), 0, H - 1)
    y1 = np.clip(y0 + 1, 0, H - 1)
    x0 = np.clip(x0f.astype(np.int64), 0, W - 1)
    x1 = np.clip(x0 + 1, 0, W - 1)
    bi = np.arange(n)[:, None, None]
    xf = x.astype(np.float32)
    r0 = xf[bi, y0[:, :, None], x0[:, None, :], :] * (1 - wx) + \
         xf[bi, y0[:, :, None], x1[:, None, :], :] * wx
    r1 = xf[bi, y1[:, :, None], x0[:, None, :], :] * (1 - wx) + \
         xf[bi, y1[:, :, None], x1[:, None, :], :] * wx
    return r0 * (1 - wy) + r1 * wy


def random_resized_crop(
    x: np.ndarray,
    rng: np.random.Generator,
    out_size: int = 224,
    scale=(0.08, 1.0),
    ratio=(3.0 / 4.0, 4.0 / 3.0),
    attempts: int = 10,
) -> np.ndarray:
    """torchvision ``RandomResizedCrop`` semantics, vectorized over the batch:
    per image, 10 attempts sampling area ∈ scale·A (uniform) and aspect ratio
    (log-uniform); the first in-bounds candidate wins, else a ratio-clamped
    center crop; the box is bilinear-resized to (out_size, out_size)."""
    n, H, W, _ = x.shape
    area = float(H * W)
    target_area = area * rng.uniform(scale[0], scale[1], size=(n, attempts))
    ar = np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1]), size=(n, attempts)))
    w = np.round(np.sqrt(target_area * ar)).astype(np.int64)
    h = np.round(np.sqrt(target_area / ar)).astype(np.int64)
    valid = (0 < w) & (w <= W) & (0 < h) & (h <= H)
    first = np.argmax(valid, axis=1)
    has = valid.any(axis=1)
    rows = np.arange(n)
    w_sel, h_sel = w[rows, first], h[rows, first]
    # fallback: whole-image center crop clamped to the ratio bounds
    in_ratio = W / H
    if in_ratio < ratio[0]:
        fw, fh = W, int(round(W / ratio[0]))
    elif in_ratio > ratio[1]:
        fw, fh = int(round(H * ratio[1])), H
    else:
        fw, fh = W, H
    w_sel = np.where(has, w_sel, fw)
    h_sel = np.where(has, h_sel, fh)
    top = rng.integers(0, H - h_sel + 1)
    left = rng.integers(0, W - w_sel + 1)
    top = np.where(has, top, (H - h_sel) // 2)
    left = np.where(has, left, (W - w_sel) // 2)
    return _bilinear_crop_resize(x, top, left, h_sel, w_sel, out_size, out_size)


def resize_center_crop(x: np.ndarray, resize: int = 256, crop: int = 224) -> np.ndarray:
    """torchvision eval stack ``Resize(resize) + CenterCrop(crop)``
    (reference dataloaders.py:154-155): shorter side to ``resize`` keeping
    aspect, then a centered ``crop`` x ``crop`` window."""
    n, H, W, _ = x.shape
    s = resize / min(H, W)
    new_h, new_w = int(round(H * s)), int(round(W * s))
    # one shared source box expressed in input coordinates: the center-crop
    # window mapped back through the resize
    crop_h_src = crop * H / new_h
    crop_w_src = crop * W / new_w
    top = (H - crop_h_src) / 2.0
    left = (W - crop_w_src) / 2.0
    ones = np.ones(n, np.float32)
    return _bilinear_crop_resize(
        x, ones * top, ones * left, ones * crop_h_src, ones * crop_w_src, crop, crop
    )


TINYIMG_SIZE = 224


def augment_batch(
    x_uint8: np.ndarray, dataset: str, rng: np.random.Generator
) -> np.ndarray:
    if dataset == "tinyimg":
        x = random_resized_crop(x_uint8, rng, TINYIMG_SIZE)
        do = rng.random(len(x)) < 0.5
        x = np.where(do[:, None, None, None], x[:, :, ::-1, :], x)
        return normalize(x, dataset)
    padding, flip = AUGMENT[dataset]
    x = random_crop_flip(x_uint8, rng, padding, flip)
    return normalize(x, dataset)
