"""FCN: 784 -> 256 -> num_classes MLP with a ReLU between (counterpart of
``gqx/models/fcn.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from gqx_torch.models.common import Dense, nhwc_flatten


class FCN(nn.Module):
    def __init__(self, num_classes: int = 10, hidden: int = 256, d_in: int = 784,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc1 = Dense(d_in, hidden, dtype, flax_path="TorchDense_0/Dense_0")
        self.fc2 = Dense(hidden, num_classes, dtype, flax_path="TorchDense_1/Dense_0")

    def forward(self, x):
        x = nhwc_flatten(x).to(self.dtype)
        return self.fc2(F.relu(self.fc1(x))).to(torch.float32)
