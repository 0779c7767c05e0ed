"""Model registry (counterpart of ``gqx/models/__init__.py``).  This slice
ports the ResNets and the FCN; the other names raise until their port
lands (ROADMAP Queue 1, item 11)."""

from __future__ import annotations

import torch

from gqx_torch.models.common import reset_parameters
from gqx_torch.models.fcn import FCN
from gqx_torch.models.resnet import ResNet18, ResNet34, ResNet50, ResNet101, ResNet152

NETWORKS = {
    "resnet18": ResNet18,
    "resnet34": ResNet34,
    "resnet50": ResNet50,
    "resnet101": ResNet101,
    "resnet152": ResNet152,
    "fcn": FCN,
}
_NOT_PORTED = ("vgg11", "vgg13", "vgg16", "vgg19", "dense", "cnn")


def create_model(name: str, num_classes: int, dtype: str = "float32",
                 generator: torch.Generator = None):
    """Build ``name`` on the CPU with torch's default init drawn from
    ``generator``; move it with ``.to(device)``."""
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"network {name!r} is not ported yet (ROADMAP Queue 1, item 11)")
    if name not in NETWORKS:
        raise ValueError(f"unknown network {name!r}")
    d = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    model = NETWORKS[name](num_classes=num_classes, dtype=d)
    reset_parameters(model, generator)
    return model
