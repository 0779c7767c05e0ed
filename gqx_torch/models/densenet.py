"""DenseNet-BC for CIFAR (counterpart of ``gqx/models/densenet.py``).

Bottleneck: BN, ReLU, 1x1 conv to 4*growth, BN, ReLU, 3x3 conv to growth,
then the new channels concatenated before the old ones (gqx's
``concatenate([out, x])``).  Transition: BN, ReLU, 1x1 conv to half the
channels, 2x2 average pool.  Then BN, ReLU, a 4x4 average pool and one
dense layer sized from the image shape.  Convs are bias-free.
``densenet_cifar`` is growth 12 with blocks (6, 12, 24, 16).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from gqx_torch.models.common import (BatchNorm, Conv2d, Dense, avg_pool, check_classifier_input,
                                     nhwc_flatten)


class DenseBottleneck(nn.Module):
    def __init__(self, cin: int, growth_rate: int, dtype: torch.dtype):
        super().__init__()
        self.bn1 = BatchNorm(cin, "BatchNorm_0/BatchNorm_0")
        self.conv1 = Conv2d(cin, 4 * growth_rate, 1, 1, dtype, "TorchConv_0/Conv_0")
        self.bn2 = BatchNorm(4 * growth_rate, "BatchNorm_1/BatchNorm_0")
        self.conv2 = Conv2d(4 * growth_rate, growth_rate, 3, 1, dtype, "TorchConv_1/Conv_0")

    def forward(self, x):
        out = self.conv1(F.relu(self.bn1(x)))
        out = self.conv2(F.relu(self.bn2(out)))
        return torch.cat([out, x], dim=1)


class Transition(nn.Module):
    def __init__(self, cin: int, out_planes: int, dtype: torch.dtype):
        super().__init__()
        self.bn = BatchNorm(cin, "BatchNorm_0/BatchNorm_0")
        self.conv = Conv2d(cin, out_planes, 1, 1, dtype, "TorchConv_0/Conv_0")

    def forward(self, x):
        return avg_pool(self.conv(F.relu(self.bn(x))), 2)


class DenseNet(nn.Module):
    def __init__(self, nblocks: Sequence[int], growth_rate: int = 12, reduction: float = 0.5,
                 num_classes: int = 10, dtype: torch.dtype = torch.float32,
                 image_shape=(32, 32, 3)):
        super().__init__()
        self.dtype = dtype
        self.image_shape = tuple(image_shape)
        h, w, c = image_shape
        num_planes = 2 * growth_rate
        self.conv1 = Conv2d(c, num_planes, 3, 1, dtype, "TorchConv_0/Conv_0")
        self.features = nn.Sequential()
        index = 0   # flax numbers bottlenecks and transitions across the whole network
        for stage, nblock in enumerate(nblocks):
            for _ in range(nblock):
                b = DenseBottleneck(num_planes, growth_rate, dtype)
                b.flax_path = f"DenseBottleneck_{index}"
                self.features.append(b)
                index += 1
                num_planes += growth_rate
            if stage != len(nblocks) - 1:
                out_planes = int(math.floor(num_planes * reduction))
                t = Transition(num_planes, out_planes, dtype)
                t.flax_path = f"Transition_{stage}"
                self.features.append(t)
                num_planes = out_planes
                h, w = h // 2, w // 2
        self.bn = BatchNorm(num_planes, "BatchNorm_0/BatchNorm_0")
        check_classifier_input(f"DenseNet {tuple(nblocks)} growth {growth_rate}", image_shape,
                               h // 4, w // 4)
        self.linear = Dense(num_planes * (h // 4) * (w // 4), num_classes, dtype,
                            flax_path="TorchDense_0/Dense_0")

    def forward(self, x):
        x = self.features(self.conv1(x.to(self.dtype)))
        x = avg_pool(F.relu(self.bn(x)), 4)
        return self.linear(nhwc_flatten(x)).to(torch.float32)


def densenet_cifar(num_classes=10, dtype=torch.float32, **kw):
    return DenseNet((6, 12, 24, 16), growth_rate=12, num_classes=num_classes, dtype=dtype, **kw)


def DenseNet121(num_classes=10, dtype=torch.float32, **kw):
    return DenseNet((6, 12, 24, 16), growth_rate=32, num_classes=num_classes, dtype=dtype, **kw)


def DenseNet169(num_classes=10, dtype=torch.float32, **kw):
    return DenseNet((6, 12, 32, 32), growth_rate=32, num_classes=num_classes, dtype=dtype, **kw)


def DenseNet201(num_classes=10, dtype=torch.float32, **kw):
    return DenseNet((6, 12, 48, 32), growth_rate=32, num_classes=num_classes, dtype=dtype, **kw)


def DenseNet161(num_classes=10, dtype=torch.float32, **kw):
    return DenseNet((6, 12, 36, 24), growth_rate=48, num_classes=num_classes, dtype=dtype, **kw)
