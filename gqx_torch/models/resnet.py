"""CIFAR-style ResNet-18/34/50/101/152 (counterpart of ``gqx/models/resnet.py``).

3x3 stem at stride 1 and no max-pool (the CIFAR variant), stages of
64/128/256/512 filters at strides 1/2/2/2, BasicBlock (expansion 1) for
18/34 and Bottleneck (expansion 4) for 50/101/152, a 4x4 average pool
before the classifier; convs are bias-free, shortcuts a 1x1 conv + BN where
the shape changes.  Parameter counts equal the reference's.
"""

from __future__ import annotations

from typing import Sequence, Type

import torch
import torch.nn.functional as F
from torch import nn

from gqx_torch.models.common import BatchNorm, Conv2d, Dense, nhwc_flatten


def _conv_bn(cin, cout, k, stride, dtype, i):
    """Conv i and BN i of a block, named as gqx names them."""
    return (Conv2d(cin, cout, k, stride, dtype, flax_path=f"TorchConv_{i}/Conv_0"),
            BatchNorm(cout, flax_path=f"BatchNorm_{i}/BatchNorm_0"))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int, dtype: torch.dtype):
        super().__init__()
        self.conv1, self.bn1 = _conv_bn(cin, filters, 3, stride, dtype, 0)
        self.conv2, self.bn2 = _conv_bn(filters, filters, 3, 1, dtype, 1)
        self.shortcut = None
        if stride != 1 or cin != filters:
            self.shortcut = nn.Sequential(*_conv_bn(cin, filters, 1, stride, dtype, 2))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.shortcut is not None:
            x = self.shortcut(x)
        return F.relu(out + x)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int, dtype: torch.dtype):
        super().__init__()
        out_ch = filters * self.expansion
        self.conv1, self.bn1 = _conv_bn(cin, filters, 1, 1, dtype, 0)
        self.conv2, self.bn2 = _conv_bn(filters, filters, 3, stride, dtype, 1)
        self.conv3, self.bn3 = _conv_bn(filters, out_ch, 1, 1, dtype, 2)
        self.shortcut = None
        if stride != 1 or cin != out_ch:
            self.shortcut = nn.Sequential(*_conv_bn(cin, out_ch, 1, stride, dtype, 3))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.shortcut is not None:
            x = self.shortcut(x)
        return F.relu(out + x)


class ResNet(nn.Module):
    def __init__(self, block: Type[nn.Module], stage_sizes: Sequence[int],
                 num_classes: int = 10, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv2d(3, 64, 3, 1, dtype, flax_path="TorchConv_0/Conv_0")
        self.bn1 = BatchNorm(64, flax_path="BatchNorm_0/BatchNorm_0")
        cin, index = 64, 0
        for s, (filters, blocks) in enumerate(zip((64, 128, 256, 512), stage_sizes)):
            layer = nn.Sequential()
            for j in range(blocks):
                b = block(cin, filters, (1 if s == 0 else 2) if j == 0 else 1, dtype)
                # flax numbers blocks across the whole network
                b.flax_path = f"{block.__name__}_{index}"
                layer.append(b)
                cin = filters * block.expansion
                index += 1
            setattr(self, f"layer{s + 1}", layer)
        self.linear = Dense(cin, num_classes, dtype, flax_path="TorchDense_0/Dense_0")

    def forward(self, x):
        x = x.to(self.dtype)
        x = F.relu(self.bn1(self.conv1(x)))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        x = F.avg_pool2d(x, 4)
        return self.linear(nhwc_flatten(x)).to(torch.float32)


def ResNet18(num_classes=10, dtype=torch.float32):
    return ResNet(BasicBlock, (2, 2, 2, 2), num_classes, dtype)


def ResNet34(num_classes=10, dtype=torch.float32):
    return ResNet(BasicBlock, (3, 4, 6, 3), num_classes, dtype)


def ResNet50(num_classes=10, dtype=torch.float32):
    return ResNet(Bottleneck, (3, 4, 6, 3), num_classes, dtype)


def ResNet101(num_classes=10, dtype=torch.float32):
    return ResNet(Bottleneck, (3, 4, 23, 3), num_classes, dtype)


def ResNet152(num_classes=10, dtype=torch.float32):
    return ResNet(Bottleneck, (3, 8, 36, 3), num_classes, dtype)
