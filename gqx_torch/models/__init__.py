"""Model registry (counterpart of ``gqx/models/__init__.py``): gqx's twelve
networks under gqx's names."""

from __future__ import annotations

import torch

from gqx_torch.models.cnn import CNN
from gqx_torch.models.common import reset_parameters
from gqx_torch.models.densenet import (DenseNet, DenseNet121, DenseNet161,  # noqa: F401
                                       DenseNet169, DenseNet201, densenet_cifar)
from gqx_torch.models.fcn import FCN
from gqx_torch.models.resnet import ResNet18, ResNet34, ResNet50, ResNet101, ResNet152
from gqx_torch.models.vgg import vgg11, vgg13, vgg16, vgg19

NETWORKS = {
    "resnet18": ResNet18,
    "resnet34": ResNet34,
    "resnet50": ResNet50,
    "resnet101": ResNet101,
    "resnet152": ResNet152,
    "vgg11": vgg11,
    "vgg13": vgg13,
    "vgg16": vgg16,
    "vgg19": vgg19,
    "dense": densenet_cifar,
    "fcn": FCN,
    "cnn": CNN,
}


def create_model(name: str, num_classes: int, dtype: str = "float32",
                 generator: torch.Generator = None, image_shape=None):
    """Build ``name`` on the CPU with torch's default init drawn from
    ``generator``; move it with ``.to(device)``.  ``image_shape`` (H, W, C)
    sizes the layers that gqx's modules size from their first input (the
    FCN's input, the stems and the classifiers); None keeps each model's
    own default (the FCN and the CNN 28x28x1, the others 32x32x3), which
    the model keeps as ``image_shape``.  As in
    gqx, the CNN is built without a compute dtype: it is float32 whatever
    ``dtype`` says."""
    if name not in NETWORKS:
        raise ValueError(f"unknown network {name!r}")
    kw = {} if image_shape is None else {"image_shape": tuple(image_shape)}
    if name != "cnn":
        kw["dtype"] = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    model = NETWORKS[name](num_classes=num_classes, **kw)
    reset_parameters(model, generator)
    return model
