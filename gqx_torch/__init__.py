"""gqx_torch — gradient-quantization training in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

The package mirrors ``gqx`` (the JAX/TPU reference) module by module, so
each module here has a counterpart of the same name there.  It imports
torch, numpy and scipy only; the cross-package parity tests are the one
place both packages meet.

Entry points (``python -m gqx_torch.cli``, ``python -m gqx_torch.bench``,
``runner.run_training``, ``train.create_train_state`` /
``train.make_train_step``) run on the CUDA device unless the caller asks
for the CPU (``--platform cpu``, ``device="cpu"``); on the CPU every kernel
wrapper computes its plain PyTorch version instead.
"""

import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  ``"cuda"`` (the default of the
    entry points) raises when no CUDA device exists — nothing silently
    moves to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "gqx_torch: a CUDA device was requested but none is available; "
            "pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
