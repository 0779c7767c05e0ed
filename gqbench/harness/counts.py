"""Operations and bytes from a configuration's shapes and a traffic mix, and
the chip's published peaks: what a roofline share or a utilization divides.

Counted from the configuration file alone, by its model family
(``flops_per_sample``; the image families' ``conv_shapes`` for the
per-user conv weight gradient), never from the measured program, so every
implementation of a layer is held to the same work.
"""

from __future__ import annotations

import math
from typing import Dict, List

from gqbench.reference import model as ref_model
from gqbench.reference import step as ref_step

# NVIDIA H100 SXM, data sheet, dense rates: bf16 tensor FLOP/s, HBM3 bytes/s
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BPS = 3.35e12

DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def flops_per_sample(spec) -> float:
    """Forward + backward operations of one training sample, as the model's
    family counts them."""
    return ref_model.family(spec).flops_per_sample(spec)


def macs_per_image(spec) -> int:
    """Multiply-adds of one image's forward in the image families: every
    convolution and the dense layer (batch norm, pooling and activations
    are not counted)."""
    return sum(c["cin"] * c["cout"] * c["k"] * c["k"] * c["ho"] * c["wo"]
               for c in ref_model.conv_shapes(spec))


def train_flops_per_image(spec) -> float:
    """``flops_per_sample``: for the image families 3 x 2 x MACs (data and
    weight gradients), no recomputation."""
    return flops_per_sample(spec)


def least_ms(bytes_moved: float, flops: float, peak_flops: float = PEAK_BF16_FLOPS) -> float:
    """The least time the chip could take: the larger of the bytes over the
    memory bandwidth and the operations over the peak, in ms."""
    return max(bytes_moved / PEAK_HBM_BPS, flops / peak_flops) * 1e3


def chips(traffic) -> int:
    """The chips one round runs on: the mix's ranks under the mesh backend."""
    return traffic["chips"] if traffic["backend"] == "mesh" else 1


def users_per_chip(traffic) -> int:
    """Each chip computes its own users' gradients and encodes."""
    return traffic["num_users"] // chips(traffic)


def per_user_dw_convs(spec) -> List[Dict[str, int]]:
    """The convolutions whose per-user weight gradient the per-user kernel
    computes: stride 1, a window of more than one tap, output the size of
    the input."""
    return [c for c in ref_model.conv_shapes(spec)
            if not c.get("dense") and c["stride"] == 1 and c["k"] > 1
            and (c["ho"], c["wo"]) == (c["h"], c["w"])]


def per_user_dw_least_ms(spec, traffic) -> float:
    """Least ms of one step's per-user weight gradients on one chip: per
    conv, 2 k^2 U B H W cin cout operations for the chip's U users; the
    input and output gradient read once in the compute dtype and the
    (U, cout, cin, k, k) float32 result written once."""
    users, batch = users_per_chip(traffic), traffic["batch_size"]
    size = DTYPE_BYTES[spec["compute_dtype"]]
    total = 0.0
    for c in per_user_dw_convs(spec):
        flops = 2.0 * c["k"] ** 2 * users * batch * c["h"] * c["w"] * c["cin"] * c["cout"]
        moved = (users * batch * c["h"] * c["w"] * (c["cin"] + c["cout"])) * size \
            + users * c["cout"] * c["cin"] * c["k"] ** 2 * 4
        total += least_ms(moved, flops)
    return total


def hsq_unit_rows(spec, traffic) -> int:
    """Subvectors of one user's HSQ units (the pad included)."""
    rows = 0
    for unit in ref_step.plan(spec, traffic):
        if unit["kind"] == "hsq":
            rows += (sum(unit["sizes"]) + unit["pad"]) // unit["dim"]
    return rows


def hsq_encode_least_ms(spec, traffic) -> float:
    """Least ms of one step's HSQ encode on one chip: 2 K dim operations a
    subvector of each of the chip's users; the unit read once in the compute
    dtype, a float32 scale and a one-byte code written a subvector, the
    float32 codebook read."""
    rows = users_per_chip(traffic) * hsq_unit_rows(spec, traffic)
    k, dim = 2 ** traffic["k_bit"], traffic["c_dim"]
    size = DTYPE_BYTES[spec["compute_dtype"]]
    code = 1 if traffic["k_bit"] <= 8 else 4
    moved = rows * dim * size + rows * (4 + code) + k * dim * 4
    return least_ms(moved, 2.0 * rows * k * dim)


def parameters(spec) -> int:
    return sum(math.prod(s) for _, s, _ in ref_model.leaves(spec))
