"""Typed configuration (counterpart of ``gqx/config.py``).

Field names and defaults are gqx's, so a config can be written once for
both packages.  Switches that exist only for the TPU build accept just the
value this port implements and raise otherwise (``_PORT_ONLY``).  The port
always plans HSQ units the way gqx does with ``use_pallas=True``: units
padded to 65,536 elements, the pad as its own norm segment, and the
bf16-exact codebook.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

DATASET_CLASSES = {
    "mnist": 10,
    "cifar10": 10,
    "cifar100": 100,
    "stl10": 10,
    "svhn": 10,
    "tinyimg": 200,
    "synthetic": 10,
    "digits": 10,
    "digits32": 10,
}

QUANTIZER_CHOICES = (
    "sgd", "qsgd", "hsq", "sign", "topk",
    "pvq", "residual", "maurey",
    "terngrad",
)

NETWORK_CHOICES = (
    "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
    "vgg11", "vgg13", "vgg16", "vgg19", "dense", "fcn", "cnn",
)

# field -> the values the port accepts (TPU-only switches of gqx)
_PORT_ONLY = {
    "use_pallas": (None, True),
    "scan_blocks": (False,),
    "backend": ("sim", "mesh"),
    "wire": ("logical", "packed"),
    "hsq_passes": (1, 2),
    "unit_dtype": ("auto", "float32", "bfloat16"),
    "compute_dtype": ("float32", "bfloat16"),
    "quant_layout": ("outfirst", "torch", "natural"),
}


@dataclasses.dataclass
class GQConfig:
    """Training configuration; see ``gqx.config.GQConfig`` for what each
    field means in the reference."""

    network: str = "resnet18"
    dataset: str = "cifar10"
    num_classes: Optional[int] = None
    quantizer: str = "hsq"
    mode: str = "ps"
    scale: str = "exp"

    c_dim: int = 32
    k_bit: int = 8
    n_bit: int = 8
    cr: int = 256
    random: bool = True

    num_users: int = 8
    logdir: Optional[str] = None
    batch_size: int = 32
    test_batch_size: int = 1000
    epochs: int = 350
    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 5e-4
    ef: bool = False
    seed: int = 1
    log_epoch: int = 1
    save_model: bool = False
    two_phase: bool = False

    backend: str = "sim"
    wire: str = "logical"
    compute_dtype: str = "float32"
    passthrough_threshold: int = 1000
    grouping: str = "auto"
    quant_layout: str = "outfirst"
    scan_blocks: bool = False
    ring_mode: str = "chain"
    codebook_dir: Optional[str] = None
    data_dir: str = "./data"
    use_pallas: Optional[bool] = None
    hsq_passes: int = 1
    unit_dtype: str = "auto"
    # True: one forward/backward on the folded (U*B) batch with per-user
    # weight gradients (gqx's canonical step); False: a loop over the users
    folded_users: bool = True
    mesh_axis: str = "users"
    eval_batch_count: Optional[int] = None
    dataset_kwargs: Optional[dict] = None
    # the runner writes a torch.profiler trace of profile_steps steps from
    # step 2 here (gqx: an xprof trace)
    profile_dir: Optional[str] = None
    profile_steps: int = 5

    def __post_init__(self):
        if self.num_classes is None:
            self.num_classes = DATASET_CLASSES.get(self.dataset, 10)
        if self.quantizer not in QUANTIZER_CHOICES:
            raise ValueError(f"unknown quantizer {self.quantizer!r}")
        if self.mode not in ("ps", "ring"):
            raise ValueError(f"unknown mode {self.mode!r}")
        self.validate()

    def validate(self):
        """Raise on a TPU-only switch set to a value the port lacks.  Called
        at construction and again by the entry points, since dataclass
        fields can be reassigned afterwards."""
        for field, allowed in _PORT_ONLY.items():
            value = getattr(self, field)
            if value not in allowed:
                raise ValueError(
                    f"gqx_torch: {field}={value!r} is not implemented by the "
                    f"port (accepted: {allowed})")

    def ef_scale(self, epoch: float) -> float:
        if self.scale == "exp":
            return 2.0 / (math.exp(-epoch) + 1.0) - 1.0
        return float(self.scale)


def resolve_schedule(config: GQConfig) -> Tuple[int, float, Sequence[int], Sequence[float], float, float]:
    """The reference's hardcoded schedules (its main.py:136-157).

    Returns (epochs, base_lr, boundaries, lrs, momentum, weight_decay)."""
    momentum = config.momentum
    weight_decay = config.weight_decay
    base_lr = config.lr

    if config.dataset in ("mnist", "digits", "digits32"):
        epochs, boundaries, lrs = 20, (), ()
    elif config.dataset == "tinyimg":
        epochs, boundaries, lrs = 1000, (51,), (0.01,)
    else:
        epochs, boundaries, lrs = 150, (51, 71), (0.01, 0.005)

    if config.quantizer == "sign":
        epochs, boundaries, lrs = 150, (51, 71), (0.0005, 0.0001)
        base_lr = 1e-3
        momentum = 0.0
        weight_decay = 0.1

    return epochs, base_lr, boundaries, lrs, momentum, weight_decay


def lr_at_epoch(epoch: int, base_lr: float, boundaries: Sequence[int], lrs: Sequence[float]) -> float:
    """Piecewise-constant LR in effect at ``epoch`` (1-based)."""
    lr = base_lr
    for b, v in zip(boundaries, lrs):
        if epoch >= b:
            lr = v
    return lr


def wd_at_epoch(epoch: int, initial_wd: float, boundaries: Sequence[int]) -> float:
    """The reference re-hardcodes weight_decay=5e-4 at every LR boundary
    (its main.py:160-163), SignSGD's 0.1 included."""
    for b in boundaries:
        if epoch >= b:
            return 5e-4
    return initial_wd
