"""What the image families (``resnet``, ``vgg``) share: convolutions padded as
XLA's "SAME", batch norm in training mode, the running statistics it keeps,
the layout of a conv kernel in a compression unit, the operation counts and
the synthetic CIFAR-shaped images.

Paths are those of the reference implementation's flax trees
("Bottleneck_3/TorchConv_1/Conv_0/kernel"), so the benchmark can hand one
set of weights to the program and to the reference.  Layouts: conv kernels
(cout, cin, kh, kw), dense kernels (out, in).  Numerics follow the published
models as the reference implementation runs them: a stride-2 3x3 conv on an
even map pads (0, 1); batch norm in training normalizes each user's
micro-batch with its own biased statistics (eps 1e-5) and records them; the
classifier reads the pooled map in NHWC order.  Everything is float32; the
caller switches TF32 off.

``quant`` (the control) rounds every tensor that a network computing in a
narrower type would hold in it, and the gradients flowing back through
them; None computes in float32.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Leaf = Tuple[str, Tuple[int, ...], float]

#: the program half of every image family
PROGRAM = "image_program"
#: the leaf families: "k7", the kernel of a convolution of stride 1 with more
#: than one tap (SAME pads keep its size), whose per-user weight gradient the
#: program's own kernel computes; "conv", every other conv or dense leaf;
#: "bn", a batch norm's scale or bias
FAMILIES = ("k7", "conv", "bn")
BN_EPS = 1e-5
BN_SCALE = "/BatchNorm_0/scale"


def path_key(path: str):
    return tuple(path.split("/"))


def rounding(quant: Optional[Callable[[torch.Tensor], torch.Tensor]]):
    return quant if quant is not None else (lambda t: t)


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's "SAME" padding (lo, hi) of one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_leaves(prefix: str, cin: int, cout: int, k: int, bias: bool) -> List[Leaf]:
    bound = 1.0 / math.sqrt(cin * k * k)
    out = [(f"{prefix}/Conv_0/kernel", (cout, cin, k, k), bound)]
    if bias:
        out.append((f"{prefix}/Conv_0/bias", (cout,), bound))
    return out


def bn_leaves(prefix: str, c: int) -> List[Leaf]:
    # scale ones, bias zeros: a bound of 0 marks a leaf that is not drawn
    return [(f"{prefix}/BatchNorm_0/scale", (c,), 0.0),
            (f"{prefix}/BatchNorm_0/bias", (c,), 0.0)]


def dense_leaves(spec, fan_in: int) -> List[Leaf]:
    bound = 1.0 / math.sqrt(fan_in)
    return [("TorchDense_0/Dense_0/kernel", (spec["num_classes"], fan_in), bound),
            ("TorchDense_0/Dense_0/bias", (spec["num_classes"],), bound)]


def leaf_families(leaves: List[Leaf], k7) -> Dict[str, str]:
    """{path: family} of ``leaves``, the kernels in ``k7`` as "k7"."""
    return {p: "k7" if p in k7 else "bn" if "/BatchNorm_0/" in p else "conv"
            for p, _, _ in leaves}


def _conv(x, w, stride, q):
    k = w.shape[-1]
    ph = same_pads(x.shape[-2], k, stride)
    pw = same_pads(x.shape[-1], k, stride)
    if any(ph + pw):
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(q(x), q(w), stride=stride)


def _bn(x, params, prefix, rec):
    mean = x.mean(dim=(0, 2, 3))
    var = x.var(dim=(0, 2, 3), unbiased=False)
    if rec is not None:
        rec.stats[prefix] = (mean.detach(), var.detach())
    y = (x - mean[:, None, None]) * torch.rsqrt(var + BN_EPS)[:, None, None]
    return y * params[f"{prefix}/BatchNorm_0/scale"][:, None, None] \
        + params[f"{prefix}/BatchNorm_0/bias"][:, None, None]


def conv_bn(params, x, prefix: str, stride: int, rec, q):
    """The conv at ``prefix`` ("Bottleneck_0/TorchConv_1"), its bias if it
    has one, then its batch norm ("Bottleneck_0/BatchNorm_1"), which records
    its batch statistics in ``rec`` under its prefix."""
    y = _conv(x, params[f"{prefix}/Conv_0/kernel"], stride, q)
    b = params.get(f"{prefix}/Conv_0/bias")
    if b is not None:
        y = y + b[:, None, None]
    return q(_bn(q(y), params, prefix.replace("TorchConv_", "BatchNorm_"), rec))


def dense_head(params, x, q):
    """Logits of the pooled map x (N, C, H, W), read in NHWC order."""
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    w, b = params["TorchDense_0/Dense_0/kernel"], params["TorchDense_0/Dense_0/bias"]
    return q(F.linear(q(x), q(w), b))


def conv_shape(out: List[Dict[str, int]], ci, co, k, s, h, w) -> Tuple[int, int]:
    """Appends one convolution's shape to ``out``; returns its output's h, w."""
    ho, wo = -(-h // s), -(-w // s)
    out.append(dict(cin=ci, cout=co, k=k, stride=s, h=h, w=w, ho=ho, wo=wo))
    return ho, wo


def dense_shape(spec, fan_in: int) -> Dict[str, int]:
    """The dense layer as a conv of k = 1 on a 1x1 map."""
    return dict(cin=fan_in, cout=spec["num_classes"], k=1, stride=1, h=1, w=1, ho=1, wo=1,
                dense=1)


def flops_per_sample(shapes: List[Dict[str, int]]) -> float:
    """Forward + backward (data and weight gradients) of one image: 3 x 2 x
    the multiply-adds of every convolution and the dense layer (batch norm,
    pooling and activations are not counted), no recomputation."""
    return 6.0 * sum(c["cin"] * c["cout"] * c["k"] * c["k"] * c["ho"] * c["wo"] for c in shapes)


def running_stats(bn_paths: List[str], leaves: List[Leaf]):
    """Each batch norm's running mean (from 0) and variance (from 1), in
    forward order."""
    shapes = {p: s for p, s, _ in leaves}
    out = {}
    for prefix in bn_paths:
        shape = shapes[f"{prefix}{BN_SCALE}"]
        out[f"{prefix}/mean"] = (shape, 0.0)
        out[f"{prefix}/var"] = (shape, 1.0)
    return out


def update_running(spec, running: Dict[str, torch.Tensor], stats) -> None:
    """Each running statistic moved by the users' mean batch statistic,
    momentum 0.9."""
    for prefix, (mu, var) in stats.items():
        for key, batch in ((f"{prefix}/mean", mu), (f"{prefix}/var", var)):
            r = running[key]
            r.copy_(0.9 * r + 0.1 * batch.mean(0))


def unit_dims(leaves: List[Leaf]) -> Dict[str, Tuple[int, ...]]:
    """Conv kernels (cout, cin, kh, kw) enter a unit as (cout, kh, kw, cin)."""
    return {p: (0, 2, 3, 1) for p, _, _ in leaves if p.endswith("/Conv_0/kernel")}


class Data:
    """The cell's synthetic training set, made from the seed as the traffic
    file defines it: 10 class templates of U[0, 256) integers, each image
    its class's template / 2 + 64 plus N(0, 32) noise, clipped to bytes;
    an epoch's order is a permutation drawn from seed * 100003 + epoch; an
    image enters the step as (x / 255 - mean) / std, channels first."""

    def __init__(self, data, seed: int):
        shape = tuple(data["image_shape"])
        classes = data["num_classes"]
        templates = np.random.default_rng(seed).integers(0, 256, size=(classes,) + shape)
        r = np.random.default_rng(seed + 1)
        n = data["num_train"]
        self.y = r.integers(0, classes, size=n)
        noise = r.normal(0, 32, size=(n,) + shape)
        self.x = np.clip(templates[self.y] * 0.5 + 64 + noise, 0, 255).astype(np.uint8)
        self.mean, self.std = data["mean"], data["std"]
        self.seed = seed

    def batch(self, step: int, users: int, batch: int, device):
        """The ``step``-th (from 0) global batch of epoch 1: x (U, B, C, H,
        W) float32, y (U, B) int64."""
        order = np.random.default_rng(self.seed * 100003 + 1).permutation(len(self.x))
        g = users * batch
        idx = order[step * g:(step + 1) * g]
        x = (self.x[idx].astype(np.float32) / np.float32(255.0) - np.float32(self.mean)) \
            / np.float32(self.std)
        x = torch.from_numpy(x).to(device).permute(0, 3, 1, 2)
        x = x.reshape((users, batch) + tuple(x.shape[1:]))
        y = torch.from_numpy(self.y[idx].astype(np.int64)).to(device).reshape(users, batch)
        return x, y
