"""LeNet-style MNIST CNN (counterpart of ``gqx/models/cnn.py``): conv
20@5x5 VALID with a bias, ReLU, 2x2 max-pool; conv 50@5x5 VALID with a
bias, ReLU, 2x2 max-pool; dense 500 with ReLU; dense to the classes;
log-softmax.  No BN, and always float32: gqx builds it without a compute
dtype."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from gqx_torch.models.common import (Conv2d, Dense, check_classifier_input, max_pool,
                                     nhwc_flatten)


class CNN(nn.Module):
    def __init__(self, num_classes: int = 10, image_shape=(28, 28, 1)):
        super().__init__()
        self.image_shape = tuple(image_shape)
        h, w, c = image_shape
        f32 = torch.float32
        self.conv1 = Conv2d(c, 20, 5, 1, f32, "TorchConv_0/Conv_0", bias=True, padding="VALID")
        self.conv2 = Conv2d(20, 50, 5, 1, f32, "TorchConv_1/Conv_0", bias=True, padding="VALID")
        for _ in range(2):        # a 5x5 VALID conv, then the 2x2 pool
            h, w = (h - 4) // 2, (w - 4) // 2
        check_classifier_input("CNN", image_shape, h, w)
        self.fc1 = Dense(50 * h * w, 500, f32, flax_path="TorchDense_0/Dense_0")
        self.fc2 = Dense(500, num_classes, f32, flax_path="TorchDense_1/Dense_0")

    def forward(self, x):
        x = max_pool(F.relu(self.conv1(x.to(torch.float32))), 2)
        x = max_pool(F.relu(self.conv2(x)), 2)
        x = self.fc2(F.relu(self.fc1(nhwc_flatten(x))))
        return F.log_softmax(x, dim=-1)
