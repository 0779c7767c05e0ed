"""A model family kept for the tests: the program's FCN (``network: "fcn"``),
a dense layer of ``hidden`` units, ReLU, and a dense classifier, on the
CIFAR-shaped synthetic images read in NHWC order (3072 inputs).  It has no
convolution, no batch norm and no running statistics, so its cells compare
``grad.dense`` and ``change.dense`` and no ``bn_stats``.  The program half is
the image families'; the training set is the shared synthetic images."""

from __future__ import annotations

import math

import torch.nn.functional as F

PROGRAM = "image_program"
FAMILIES = ("dense",)


def _layers(spec):
    """(fan_in, width) of each dense layer, in order."""
    d_in = math.prod(spec["image_shape"])
    return [(d_in, spec["hidden"]), (spec["hidden"], spec["num_classes"])]


def leaves(spec):
    out = []
    for i, (fan_in, width) in enumerate(_layers(spec)):
        bound = 1.0 / math.sqrt(fan_in)
        out += [(f"TorchDense_{i}/Dense_0/kernel", (width, fan_in), bound),
                (f"TorchDense_{i}/Dense_0/bias", (width,), bound)]
    return sorted(out, key=lambda leaf: tuple(leaf[0].split("/")))


def leaf_families(spec):
    return {p: "dense" for p, _, _ in leaves(spec)}


def user_loss(spec, params, x, y, rec=None, quant=None):
    q = quant if quant is not None else (lambda t: t)
    x = q(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))
    for i in range(len(_layers(spec))):
        if i:
            x = F.relu(x)
        w, b = params[f"TorchDense_{i}/Dense_0/kernel"], params[f"TorchDense_{i}/Dense_0/bias"]
        x = q(F.linear(q(x), q(w), b))
    return F.cross_entropy(x, y)


def running_stats(spec):
    return {}


def update_running(spec, running, stats):
    pass


def unit_dims(spec):
    return {}


def flops_per_sample(spec):
    return 6.0 * sum(fan_in * width for fan_in, width in _layers(spec))
