"""The ResNet family (arXiv:1512.03385, the CIFAR variant of kuangliu's
``models/resnet.py``): a 3x3 stem, stages of basic or bottleneck blocks, each
conv followed by batch norm, a projection shortcut where the shape changes,
average pooling and one dense layer.  The sizes come from the configuration
(``block``, ``stem_width``, ``stem_kernel``, ``stage_widths``,
``stage_blocks``, ``stage_strides``, ``expansion``, ``pool``,
``image_shape``, ``num_classes``); the rest is ``images``'s.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch.nn.functional as F

from gqbench.families import images
from gqbench.families.images import FAMILIES, PROGRAM, Leaf  # noqa: F401

_BLOCK = {"bottleneck": "Bottleneck", "basic": "BasicBlock"}


def _blocks(spec):
    """(block path, cin, filters, stride) of every residual block, in order."""
    cin, index = spec["stem_width"], 0
    for filters, blocks, stride in zip(spec["stage_widths"], spec["stage_blocks"],
                                       spec["stage_strides"]):
        for j in range(blocks):
            yield (f"{_BLOCK[spec['block']]}_{index}", cin, filters, stride if j == 0 else 1)
            cin = filters * spec["expansion"]
            index += 1


def _shortcut(spec) -> int:
    """The index of a block's projection shortcut conv."""
    return 3 if spec["block"] == "bottleneck" else 2


def _block_convs(spec, cin, filters, stride):
    """(index, cin, cout, k, stride) of a block's convs; index 2 (basic) or 3
    (bottleneck) is the projection shortcut, present where the shape changes."""
    out_ch = filters * spec["expansion"]
    if spec["block"] == "bottleneck":
        convs = [(0, cin, filters, 1, 1), (1, filters, filters, 3, stride),
                 (2, filters, out_ch, 1, 1)]
    else:
        convs = [(0, cin, filters, 3, stride), (1, filters, filters, 3, 1)]
    if stride != 1 or cin != out_ch:
        convs.append((_shortcut(spec), cin, out_ch, 1, stride))
    return convs


def _head(spec) -> Tuple[int, int]:
    """The classifier's width and the pooled map's (h, w)."""
    h, w, _ = spec["image_shape"]
    for s in spec["stage_strides"]:
        h, w = -(-h // s), -(-w // s)
    return spec["stage_widths"][-1] * spec["expansion"], (h // spec["pool"], w // spec["pool"])


def _fan_in(spec) -> int:
    width, (ph, pw) = _head(spec)
    return width * ph * pw


def leaves(spec) -> List[Leaf]:
    """(path, shape, bound) of every trainable leaf, sorted by path
    components.  A conv or dense leaf is drawn from U(-bound, bound), the
    init of the reference models (1 / sqrt(fan_in) for kernels and
    biases); batch norm scales start at 1 and biases at 0 (bound 0)."""
    out = images.conv_leaves("TorchConv_0", spec["image_shape"][2], spec["stem_width"],
                             spec["stem_kernel"], False)
    out += images.bn_leaves("BatchNorm_0", spec["stem_width"])
    for path, cin, filters, stride in _blocks(spec):
        for i, ci, co, k, _ in _block_convs(spec, cin, filters, stride):
            out += images.conv_leaves(f"{path}/TorchConv_{i}", ci, co, k, False)
            out += images.bn_leaves(f"{path}/BatchNorm_{i}", co)
    out += images.dense_leaves(spec, _fan_in(spec))
    return sorted(out, key=lambda leaf: images.path_key(leaf[0]))


def leaf_families(spec) -> Dict[str, str]:
    """{path: family}: the stem's and the blocks' stride-1 kernels of more
    than one tap are "k7" (``images.FAMILIES``)."""
    k7 = set()
    if spec["stem_kernel"] > 1:
        k7.add("TorchConv_0/Conv_0/kernel")
    for path, cin, filters, stride in _blocks(spec):
        k7 |= {f"{path}/TorchConv_{i}/Conv_0/kernel"
               for i, _, _, k, s in _block_convs(spec, cin, filters, stride)
               if k > 1 and s == 1}
    return images.leaf_families(leaves(spec), k7)


def bn_paths(spec) -> List[str]:
    """The prefix of every batch norm ("Bottleneck_0/BatchNorm_1"), in
    forward order."""
    out = ["BatchNorm_0"]
    for path, cin, filters, stride in _blocks(spec):
        out += [f"{path}/BatchNorm_{i}" for i, *_ in _block_convs(spec, cin, filters, stride)]
    return out


def forward(spec, params, x, rec=None, quant=None):
    """Logits (N, classes) of images x (N, C, H, W) float32, batch norm in
    training mode over the N images.  ``quant`` rounds the operands of each
    convolution and dense product, their results, each batch norm's output,
    each residual sum and the pooled map (and the gradients flowing back
    through them)."""
    q = images.rounding(quant)
    x = q(x)
    x = F.relu(images.conv_bn(params, x, "TorchConv_0", 1, rec, q))
    for path, cin, filters, stride in _blocks(spec):
        convs = _block_convs(spec, cin, filters, stride)
        main = [c for c in convs if c[0] < _shortcut(spec)]
        out = x
        for n, (i, _, _, _, s) in enumerate(main):
            out = images.conv_bn(params, out, f"{path}/TorchConv_{i}", s, rec, q)
            if n < len(main) - 1:
                out = F.relu(out)
        short = [c for c in convs if c not in main]
        sc = images.conv_bn(params, x, f"{path}/TorchConv_{short[0][0]}", short[0][4], rec, q) \
            if short else x
        x = F.relu(q(out + sc))
    x = q(F.avg_pool2d(x, spec["pool"], spec["pool"]))
    return images.dense_head(params, x, q)


def user_loss(spec, params, x, y, rec=None, quant=None):
    """The cross-entropy of one user's logits."""
    return F.cross_entropy(forward(spec, params, x, rec, quant), y)


def conv_shapes(spec) -> List[Dict[str, int]]:
    """Every convolution of one image's forward: cin, cout, k, stride, the
    input's h and w and the output's ho and wo; then the dense layer as
    k = 1 on a 1x1 map."""
    h, w, c = spec["image_shape"]
    out: List[Dict[str, int]] = []
    h, w = images.conv_shape(out, c, spec["stem_width"], spec["stem_kernel"], 1, h, w)
    for _, cin, filters, stride in _blocks(spec):
        hi, wi = h, w
        for i, ci, co, k, s in _block_convs(spec, cin, filters, stride):
            # the main path chains; the shortcut reads the block's input
            if i == _shortcut(spec):
                images.conv_shape(out, ci, co, k, s, hi, wi)
            else:
                h, w = images.conv_shape(out, ci, co, k, s, h, w)
    out.append(images.dense_shape(spec, _fan_in(spec)))
    return out


def flops_per_sample(spec) -> float:
    return images.flops_per_sample(conv_shapes(spec))


def running_stats(spec):
    return images.running_stats(bn_paths(spec), leaves(spec))


update_running = images.update_running


def unit_dims(spec):
    return images.unit_dims(leaves(spec))
