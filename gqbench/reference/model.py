"""Plain float32 models of the benchmark's configurations, from their JSON
files alone.

A configuration names its model family (``family``); the family's module
(``gqbench/families/<family>.py``, found by ``manifest.family``) builds the
model from the configuration's sizes.  ``leaves(spec)`` lists every
trainable leaf as (path, shape, init bound) in the order ``init_weights``
draws them, and ``user_loss`` computes one user's loss from a {path:
tensor} dict of those leaves.  Paths are those of the reference
implementation's trees, so the benchmark can hand one set of weights to the
program and to this module.  Everything is float32; the caller switches
TF32 off.  ``forward``, ``conv_shapes`` and ``bn_paths`` are the image
families' own.
"""

from __future__ import annotations

import math
from types import ModuleType
from typing import Dict, List, Tuple

import torch

from gqbench.harness import manifest

Leaf = Tuple[str, Tuple[int, ...], float]


def family(spec) -> ModuleType:
    """The module of the configuration's model family."""
    return manifest.family(spec["family"])


def leaves(spec) -> List[Leaf]:
    """(path, shape, bound) of every trainable leaf, in the order of their
    draw.  A leaf is drawn from U(-bound, bound); a bound of 0 marks a leaf
    that is not drawn (``init_weights``)."""
    return family(spec).leaves(spec)


def leaf_families(spec) -> Dict[str, str]:
    """{path: leaf family} of every leaf, which the check compares apart."""
    return family(spec).leaf_families(spec)


def running_stats(spec) -> Dict[str, Tuple[Tuple[int, ...], float]]:
    """{key: (shape, start value)} of the model's running statistics."""
    return family(spec).running_stats(spec)


def init_weights(spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf from ``seed``: one draw of U(-1, 1) on ``device`` for all
    drawn leaves, in the order of ``leaves``, each slice scaled by its
    bound; a leaf not drawn is 1 where its path ends in "/scale", else 0."""
    specs = leaves(spec)
    drawn = [(p, s, b) for p, s, b in specs if b > 0.0]
    total = sum(math.prod(s) for _, s, _ in drawn)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.rand(total, generator=gen, device=device, dtype=torch.float32)
    flat.mul_(2.0).sub_(1.0)
    pieces = list(flat.split([math.prod(s) for _, s, _ in drawn]))
    torch._foreach_mul_(pieces, [b for _, _, b in drawn])
    out = {p: piece.view(s) for (p, s, _), piece in zip(drawn, pieces)}
    for p, s, b in specs:
        if b == 0.0:
            fill = 1.0 if p.endswith("/scale") else 0.0
            out[p] = torch.full(s, fill, dtype=torch.float32, device=device)
    return out


class Recorder:
    """Collects the batch values of each running statistic of one forward:
    {key: tuple of tensors}."""

    def __init__(self):
        self.stats: Dict[str, Tuple[torch.Tensor, ...]] = {}


def user_loss(spec, params, x, y, rec=None, quant=None) -> torch.Tensor:
    """One user's loss on its micro-batch (x, y); ``quant`` (the control)
    rounds every tensor that a model computing in a narrower type would
    hold in it, None computes in float32."""
    return family(spec).user_loss(spec, params, x, y, rec, quant)


def forward(spec, params, x, rec=None, quant=None) -> torch.Tensor:
    """Logits (N, classes) of images x (N, C, H, W): the image families'."""
    return family(spec).forward(spec, params, x, rec, quant)


def conv_shapes(spec) -> List[Dict[str, int]]:
    """Every convolution of one sample's forward, then the dense layer (the
    image families'); none for a family without them."""
    shapes = getattr(family(spec), "conv_shapes", None)
    return shapes(spec) if shapes is not None else []


def bn_paths(spec) -> List[str]:
    """The prefix of every batch norm, in forward order (the image
    families')."""
    return family(spec).bn_paths(spec)
