"""Data pipeline (counterpart of ``gqx/data/__init__.py``): raw readers +
augmentation (the native C++ library or vectorized numpy) + per-user
batching.

Train batches carry a leading ``users`` axis of shape
(num_users, batch_size, H, W, C), float32, with int32 labels: the layout
and the bits of gqx's ``Pipeline`` for the same seed, epoch and augment,
so the two compare array for array.  The runner moves them to the step's
(U, B, C, H, W) on the device.

The augment follows gqx's rule: the native library
(``gqx_torch.data.native``, gqx's C++ built by the port) wherever it
builds, but for ``tinyimg`` (its RandomResizedCrop is numpy's) or with
``native=False``.  The two are not bit-equal: the native one draws its
crops and flips from its own generator and normalizes by another float
formula.

Deviation from the reference (as in gqx): trailing partial global batches
are dropped; the reference gives the remainder to the last user (its
main.py:192-193).
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

from gqx_torch.data import native as native_lib
from gqx_torch.data.datasets import load_dataset
from gqx_torch.data.transforms import (
    TINYIMG_SIZE,
    augment_batch,
    normalize,
    resize_center_crop,
)
from gqx_torch.utils.profiling import span


class Pipeline:
    """In-memory dataset + epoch iterators.

    ``native``: False takes numpy's augment; otherwise the native one is
    taken where its library builds, as gqx does.  ``augment`` records the one
    taken, ``"native"`` or ``"numpy"``."""

    def __init__(self, config, native: Optional[bool] = None):
        self.dataset = config.dataset
        self.num_users = config.num_users
        self.batch_size = config.batch_size
        self.test_batch_size = config.test_batch_size
        (self.train_x, self.train_y), (self.test_x, self.test_y) = load_dataset(
            config.dataset, config.data_dir, **(config.dataset_kwargs or {}))
        self.global_batch = self.batch_size * self.num_users
        self.steps_per_epoch = len(self.train_x) // self.global_batch
        self._seed = config.seed
        self.augment = "numpy"
        if native is not False and self.dataset != "tinyimg" and native_lib.available():
            self.augment = "native"

    def train_epoch(self, epoch: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield (x, y) with x: (num_users, batch, H, W, C) float32, y int32."""
        rng = np.random.default_rng(self._seed * 100003 + epoch)
        order = rng.permutation(len(self.train_x))
        u, b = self.num_users, self.batch_size
        for step in range(self.steps_per_epoch):
            with span("gqx_torch::data.batch"):
                idx = order[step * self.global_batch: (step + 1) * self.global_batch]
                images = self.train_x[idx]
                with span("gqx_torch::data.augment"):
                    if self.augment == "native":
                        x = native_lib.augment_batch(images, self.dataset, rng)
                    else:
                        x = augment_batch(images, self.dataset, rng)
                y = self.train_y[idx].astype(np.int32)
            yield x.reshape((u, b) + x.shape[1:]), y.reshape(u, b)

    def test_batches(self, limit: Optional[int] = None) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield (x, y) test batches, x: (N, H, W, C) float32, y int32; stop
        after ``limit`` of them (gqx's rule: the first batch is always
        yielded)."""
        for count, start in enumerate(range(0, len(self.test_x), self.test_batch_size), 1):
            x = self.test_x[start: start + self.test_batch_size]
            if self.dataset == "tinyimg":
                # eval stack Resize(256) + CenterCrop(224)
                # (reference dataloaders.py:154-155)
                x = resize_center_crop(x, 256, TINYIMG_SIZE)
            y = self.test_y[start: start + self.test_batch_size].astype(np.int32)
            yield normalize(x, self.dataset), y
            if limit is not None and count >= limit:
                return

    @property
    def image_shape(self):
        if self.dataset == "tinyimg":
            # images are stored at load resolution; the train/eval transforms
            # emit 224px (reference dataloaders.py:141,154-155)
            return (TINYIMG_SIZE, TINYIMG_SIZE, 3)
        return tuple(self.train_x.shape[1:])
