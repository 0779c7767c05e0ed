"""Plain float32 forward of the benchmark's configurations, from their JSON
files alone.

A configuration names its family and sizes (``gqbench/configs/<name>.json``);
``leaves(spec)`` lists every trainable leaf as (path, shape, init bound) in
the order of its path's components, and ``forward`` computes logits from a
{path: tensor} dict of those leaves.  Paths are those of the reference
implementation's flax trees ("Bottleneck_3/TorchConv_1/Conv_0/kernel"), so
the benchmark can hand one set of weights to the program and to this
module.  Layouts: conv kernels (cout, cin, kh, kw), dense kernels (out, in).

Numerics follow the published models as the reference implementation runs
them: convolutions pad as XLA's "SAME" (a stride-2 3x3 conv on an even map
pads (0, 1)), batch norm in training normalizes each user's micro-batch
with its own biased statistics (eps 1e-5) and records them, the classifier
reads the pooled map in NHWC order.  Everything is float32; the caller
switches TF32 off.

``quant`` (the control) rounds every tensor that a network computing in a
narrower type would hold in it, and the gradients flowing back through
them; None computes in float32.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Leaf = Tuple[str, Tuple[int, ...], float]

BN_EPS = 1e-5


def _path_key(path: str):
    return tuple(path.split("/"))


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's "SAME" padding (lo, hi) of one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv_leaves(prefix: str, cin: int, cout: int, k: int, bias: bool) -> List[Leaf]:
    bound = 1.0 / math.sqrt(cin * k * k)
    out = [(f"{prefix}/Conv_0/kernel", (cout, cin, k, k), bound)]
    if bias:
        out.append((f"{prefix}/Conv_0/bias", (cout,), bound))
    return out


def _bn_leaves(prefix: str, c: int) -> List[Leaf]:
    # scale ones, bias zeros: a bound of 0 marks a leaf that is not drawn
    return [(f"{prefix}/BatchNorm_0/scale", (c,), 0.0),
            (f"{prefix}/BatchNorm_0/bias", (c,), 0.0)]


def _resnet_blocks(spec):
    """(block path, cin, filters, stride) of every residual block, in order."""
    cin, index = spec["stem_width"], 0
    for s, (filters, blocks, stride) in enumerate(
            zip(spec["stage_widths"], spec["stage_blocks"], spec["stage_strides"])):
        for j in range(blocks):
            yield (f"{_BLOCK[spec['block']]}_{index}", cin, filters, stride if j == 0 else 1)
            cin = filters * spec["expansion"]
            index += 1


_BLOCK = {"bottleneck": "Bottleneck", "basic": "BasicBlock"}


def _block_convs(spec, cin, filters, stride):
    """(index, cin, cout, k, stride) of a block's convs; index 2 (basic) or 3
    (bottleneck) is the projection shortcut, present where the shape changes."""
    out_ch = filters * spec["expansion"]
    if spec["block"] == "bottleneck":
        convs = [(0, cin, filters, 1, 1), (1, filters, filters, 3, stride),
                 (2, filters, out_ch, 1, 1)]
        short = 3
    else:
        convs = [(0, cin, filters, 3, stride), (1, filters, filters, 3, 1)]
        short = 2
    if stride != 1 or cin != out_ch:
        convs.append((short, cin, out_ch, 1, stride))
    return convs


def _pooled(spec) -> Tuple[int, int]:
    h, w, _ = spec["image_shape"]
    if spec["family"] == "resnet":
        for s in spec["stage_strides"]:
            h, w = -(-h // s), -(-w // s)
        return h // spec["pool"], w // spec["pool"]
    for entry in spec["layers"]:
        if entry == "M":
            h, w = h // 2, w // 2
    return h, w


def leaves(spec) -> List[Leaf]:
    """(path, shape, bound) of every trainable leaf, sorted by path
    components.  A conv or dense leaf is drawn from U(-bound, bound), the
    init of the reference models (1 / sqrt(fan_in) for kernels and
    biases); batch norm scales start at 1 and biases at 0 (bound 0)."""
    c = spec["image_shape"][2]
    out: List[Leaf] = []
    if spec["family"] == "resnet":
        out += _conv_leaves("TorchConv_0", c, spec["stem_width"], spec["stem_kernel"], False)
        out += _bn_leaves("BatchNorm_0", spec["stem_width"])
        cin = spec["stem_width"]
        for path, cin, filters, stride in _resnet_blocks(spec):
            for i, ci, co, k, _ in _block_convs(spec, cin, filters, stride):
                out += _conv_leaves(f"{path}/TorchConv_{i}", ci, co, k, False)
                out += _bn_leaves(f"{path}/BatchNorm_{i}", co)
        width = spec["stage_widths"][-1] * spec["expansion"]
    elif spec["family"] == "vgg":
        i = 0
        for entry in spec["layers"]:
            if entry == "M":
                continue
            out += _conv_leaves(f"TorchConv_{i}", c, int(entry), 3, spec["conv_bias"])
            out += _bn_leaves(f"BatchNorm_{i}", int(entry))
            c = int(entry)
            i += 1
        width = c
    else:
        raise ValueError(f"unknown family {spec['family']!r}")
    ph, pw = _pooled(spec)
    fan_in = width * ph * pw
    bound = 1.0 / math.sqrt(fan_in)
    out += [("TorchDense_0/Dense_0/kernel", (spec["num_classes"], fan_in), bound),
            ("TorchDense_0/Dense_0/bias", (spec["num_classes"],), bound)]
    return sorted(out, key=lambda leaf: _path_key(leaf[0]))


#: the families of leaves that the check compares apart
FAMILIES = ("k7", "conv", "bn")


def leaf_families(spec) -> Dict[str, str]:
    """{path: family} of every leaf: "k7", the kernel of a convolution of
    stride 1 with more than one tap (SAME pads keep its size), whose
    per-user weight gradient the program's own kernel computes; "bn", a
    batch norm's scale or bias; "conv", every other conv or dense leaf."""
    k7 = set()
    if spec["family"] == "resnet":
        if spec["stem_kernel"] > 1:
            k7.add("TorchConv_0/Conv_0/kernel")
        for path, cin, filters, stride in _resnet_blocks(spec):
            k7 |= {f"{path}/TorchConv_{i}/Conv_0/kernel"
                   for i, _, _, k, s in _block_convs(spec, cin, filters, stride)
                   if k > 1 and s == 1}
    else:
        convs = sum(1 for entry in spec["layers"] if entry != "M")
        k7 = {f"TorchConv_{i}/Conv_0/kernel" for i in range(convs)}
    out = {}
    for p, _, _ in leaves(spec):
        out[p] = "k7" if p in k7 else "bn" if "/BatchNorm_0/" in p else "conv"
    return out


def bn_paths(spec) -> List[str]:
    """The prefix of every batch norm ("Bottleneck_0/BatchNorm_1"), in
    forward order."""
    return [p[:-len("/BatchNorm_0/scale")] for p, _, _ in _forward_order(spec)
            if p.endswith("/BatchNorm_0/scale")]


def _forward_order(spec):
    c = spec["image_shape"][2]
    if spec["family"] == "resnet":
        seq = _bn_leaves("BatchNorm_0", spec["stem_width"])
        cin = spec["stem_width"]
        for path, cin, filters, stride in _resnet_blocks(spec):
            for i, ci, co, k, _ in _block_convs(spec, cin, filters, stride):
                seq += _bn_leaves(f"{path}/BatchNorm_{i}", co)
        return seq
    seq, i = [], 0
    for entry in spec["layers"]:
        if entry != "M":
            seq += _bn_leaves(f"BatchNorm_{i}", int(entry))
            i += 1
    return seq


def init_weights(spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf from ``seed``: one draw of U(-1, 1) on ``device`` for all
    drawn leaves, in path order, each slice scaled by its bound; batch norm
    scales 1, biases 0."""
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
    """Collects each batch norm's (mean, biased var) of one forward."""

    def __init__(self):
        self.stats: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}


def _conv(x, w, stride, q):
    k = w.shape[-1]
    ph = same_pads(x.shape[-2], k, stride)
    pw = same_pads(x.shape[-1], k, stride)
    if any(ph + pw):
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(q(x), q(w), stride=stride)


def _bn(x, params, prefix, rec: Optional[Recorder]):
    mean = x.mean(dim=(0, 2, 3))
    var = x.var(dim=(0, 2, 3), unbiased=False)
    if rec is not None:
        rec.stats[prefix] = (mean.detach(), var.detach())
    y = (x - mean[:, None, None]) * torch.rsqrt(var + BN_EPS)[:, None, None]
    return y * params[f"{prefix}/BatchNorm_0/scale"][:, None, None] \
        + params[f"{prefix}/BatchNorm_0/bias"][:, None, None]


def forward(spec, params: Dict[str, torch.Tensor], x: torch.Tensor,
            rec: Optional[Recorder] = None,
            quant: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
    """Logits (N, classes) of images x (N, C, H, W) float32, batch norm in
    training mode over the N images.  ``quant`` rounds every tensor that a
    network computing in a narrower type holds in it: the operands of each
    convolution and dense product, their results, each batch norm's output,
    each residual sum and the pooled map (and the gradients flowing back
    through them)."""
    q = quant if quant is not None else (lambda t: t)

    def conv_bn(x, prefix, stride):
        w = params[f"{prefix}/Conv_0/kernel"]
        y = _conv(x, w, stride, q)
        b = params.get(f"{prefix}/Conv_0/bias")
        if b is not None:
            y = y + b[:, None, None]
        bn_prefix = prefix.replace("TorchConv_", "BatchNorm_")
        return q(_bn(q(y), params, bn_prefix, rec))

    x = q(x)
    if spec["family"] == "resnet":
        x = F.relu(conv_bn(x, "TorchConv_0", 1))
        for path, cin, filters, stride in _resnet_blocks(spec):
            convs = _block_convs(spec, cin, filters, stride)
            main = [c for c in convs if c[0] < (3 if spec["block"] == "bottleneck" else 2)]
            out = x
            for n, (i, _, _, _, s) in enumerate(main):
                out = conv_bn(out, f"{path}/TorchConv_{i}", s)
                if n < len(main) - 1:
                    out = F.relu(out)
            short = [c for c in convs if c not in main]
            sc = conv_bn(x, f"{path}/TorchConv_{short[0][0]}", short[0][4]) if short else x
            x = F.relu(q(out + sc))
        x = q(F.avg_pool2d(x, spec["pool"], spec["pool"]))
    else:
        i = 0
        for entry in spec["layers"]:
            if entry == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                x = F.relu(conv_bn(x, f"TorchConv_{i}", 1))
                i += 1
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    w, b = params["TorchDense_0/Dense_0/kernel"], params["TorchDense_0/Dense_0/bias"]
    return q(F.linear(q(x), q(w), b))


def conv_shapes(spec) -> List[Dict[str, int]]:
    """Every convolution of one image's forward: cin, cout, k, stride, the
    input's h and w and the output's ho and wo; then the dense layer as
    k = 1 on a 1x1 map."""
    h, w, c = spec["image_shape"]
    out = []

    def add(ci, co, k, s, h, w):
        ho, wo = -(-h // s), -(-w // s)
        out.append(dict(cin=ci, cout=co, k=k, stride=s, h=h, w=w, ho=ho, wo=wo))
        return ho, wo

    if spec["family"] == "resnet":
        h, w = add(c, spec["stem_width"], spec["stem_kernel"], 1, h, w)
        for _, cin, filters, stride in _resnet_blocks(spec):
            hi, wi = h, w
            for i, ci, co, k, s in _block_convs(spec, cin, filters, stride):
                # the main path chains; the shortcut reads the block's input
                is_short = i == (3 if spec["block"] == "bottleneck" else 2)
                ho, wo = add(ci, co, k, s, hi if is_short else h, wi if is_short else w)
                if not is_short:
                    h, w = ho, wo
        width = spec["stage_widths"][-1] * spec["expansion"]
    else:
        for entry in spec["layers"]:
            if entry == "M":
                h, w = h // 2, w // 2
                continue
            add(c, int(entry), 3, 1, h, w)
            c = int(entry)
        width = c
    ph, pw = _pooled(spec)
    out.append(dict(cin=width * ph * pw, cout=spec["num_classes"], k=1, stride=1, h=1, w=1,
                    ho=1, wo=1, dense=1))
    return out
