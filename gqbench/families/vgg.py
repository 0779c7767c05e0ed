"""The VGG family with batch norm (arXiv:1409.1556, the CIFAR variant of
kuangliu's ``models/vgg.py``): ``layers`` lists the 3x3 convs' widths, each
conv followed by batch norm and ReLU, "M" a 2x2 max pool; then one dense
layer.  Sizes from the configuration (``layers``, ``conv_bias``,
``image_shape``, ``num_classes``); the rest is ``images``'s.
"""

from __future__ import annotations

from typing import Dict, List

import torch.nn.functional as F

from gqbench.families import images
from gqbench.families.images import FAMILIES, PROGRAM, Leaf  # noqa: F401


def _widths(spec) -> List[int]:
    """The convs' output widths, in order."""
    return [int(entry) for entry in spec["layers"] if entry != "M"]


def _fan_in(spec) -> int:
    """The classifier's width times the last pooled map's h and w."""
    h, w, c = spec["image_shape"]
    for entry in spec["layers"]:
        if entry == "M":
            h, w = h // 2, w // 2
    widths = _widths(spec)
    return (widths[-1] if widths else c) * h * w


def leaves(spec) -> List[Leaf]:
    """(path, shape, bound) of every trainable leaf, sorted by path
    components, as ``resnet.leaves``; a conv's bias where ``conv_bias``."""
    out: List[Leaf] = []
    c = spec["image_shape"][2]
    for i, width in enumerate(_widths(spec)):
        out += images.conv_leaves(f"TorchConv_{i}", c, width, 3, spec["conv_bias"])
        out += images.bn_leaves(f"BatchNorm_{i}", width)
        c = width
    out += images.dense_leaves(spec, _fan_in(spec))
    return sorted(out, key=lambda leaf: images.path_key(leaf[0]))


def leaf_families(spec) -> Dict[str, str]:
    """{path: family}: every conv's kernel is "k7" (``images.FAMILIES``)."""
    k7 = {f"TorchConv_{i}/Conv_0/kernel" for i in range(len(_widths(spec)))}
    return images.leaf_families(leaves(spec), k7)


def bn_paths(spec) -> List[str]:
    """The prefix of every batch norm ("BatchNorm_3"), in forward order."""
    return [f"BatchNorm_{i}" for i in range(len(_widths(spec)))]


def forward(spec, params, x, rec=None, quant=None):
    """Logits (N, classes) of images x (N, C, H, W) float32, as
    ``resnet.forward``."""
    q = images.rounding(quant)
    x = q(x)
    i = 0
    for entry in spec["layers"]:
        if entry == "M":
            x = F.max_pool2d(x, 2, 2)
        else:
            x = F.relu(images.conv_bn(params, x, f"TorchConv_{i}", 1, rec, q))
            i += 1
    return images.dense_head(params, x, q)


def user_loss(spec, params, x, y, rec=None, quant=None):
    """The cross-entropy of one user's logits."""
    return F.cross_entropy(forward(spec, params, x, rec, quant), y)


def conv_shapes(spec) -> List[Dict[str, int]]:
    """Every convolution of one image's forward, then the dense layer, as
    ``resnet.conv_shapes``."""
    h, w, c = spec["image_shape"]
    out: List[Dict[str, int]] = []
    for entry in spec["layers"]:
        if entry == "M":
            h, w = h // 2, w // 2
            continue
        images.conv_shape(out, c, int(entry), 3, 1, h, w)
        c = int(entry)
    out.append(images.dense_shape(spec, _fan_in(spec)))
    return out


def flops_per_sample(spec) -> float:
    return images.flops_per_sample(conv_shapes(spec))


def running_stats(spec):
    return images.running_stats(bn_paths(spec), leaves(spec))


update_running = images.update_running


def unit_dims(spec):
    return images.unit_dims(leaves(spec))
