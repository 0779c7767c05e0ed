"""CIFAR VGG-11/13/16/19 with BatchNorm and one classifier (counterpart of
``gqx/models/vgg.py``).

Per entry of the configuration a 3x3 SAME conv with a bias, BN and ReLU; a
2x2 max-pool at each "M"; the map flattened in gqx's NHWC order into one
dense layer sized from the image shape (512 inputs at 32x32).  Parameter
counts equal gqx's.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from gqx_torch.models.common import (BatchNorm, Conv2d, Dense, check_classifier_input, max_pool,
                                     nhwc_flatten)

CFG = {
    "VGG11": (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "VGG13": (64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "VGG16": (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M"),
    "VGG19": (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M"),
}


class VGG(nn.Module):
    def __init__(self, cfg: Sequence[Union[int, str]], num_classes: int = 10,
                 dtype: torch.dtype = torch.float32, image_shape=(32, 32, 3)):
        super().__init__()
        self.cfg = tuple(cfg)
        self.dtype = dtype
        self.image_shape = tuple(image_shape)
        h, w, cin = image_shape
        self.convs, self.bns = nn.ModuleList(), nn.ModuleList()
        for entry in self.cfg:
            if entry == "M":
                h, w = h // 2, w // 2
                continue
            i = len(self.convs)   # flax numbers convs and BNs in order
            self.convs.append(Conv2d(cin, int(entry), 3, 1, dtype, f"TorchConv_{i}/Conv_0",
                                     bias=True))
            self.bns.append(BatchNorm(int(entry), f"BatchNorm_{i}/BatchNorm_0"))
            cin = int(entry)
        check_classifier_input(f"VGG-{len(self.convs) + 3}", image_shape, h, w)
        self.linear = Dense(cin * h * w, num_classes, dtype, flax_path="TorchDense_0/Dense_0")

    def forward(self, x):
        x = x.to(self.dtype)
        layers = iter(zip(self.convs, self.bns))
        for entry in self.cfg:
            if entry == "M":
                x = max_pool(x, 2)
            else:
                conv, bn = next(layers)
                x = F.relu(bn(conv(x)))
        return self.linear(nhwc_flatten(x)).to(torch.float32)


def vgg11(num_classes=10, dtype=torch.float32, **kw):
    return VGG(CFG["VGG11"], num_classes, dtype, **kw)


def vgg13(num_classes=10, dtype=torch.float32, **kw):
    return VGG(CFG["VGG13"], num_classes, dtype, **kw)


def vgg16(num_classes=10, dtype=torch.float32, **kw):
    return VGG(CFG["VGG16"], num_classes, dtype, **kw)


def vgg19(num_classes=10, dtype=torch.float32, **kw):
    return VGG(CFG["VGG19"], num_classes, dtype, **kw)
