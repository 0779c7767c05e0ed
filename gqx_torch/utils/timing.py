"""Timing with a device barrier (counterpart of ``gqx/utils/timing.py``).

PyTorch returns from a CUDA call before the card has run it, so the clock
stops only after ``torch.cuda.synchronize`` on the output's device; on the
CPU the call has finished when it returns.
"""

from __future__ import annotations

import time

import torch


def barrier(out) -> None:
    """Wait until the device of ``out`` has run everything queued before
    it (nothing to wait for unless ``out`` is a CUDA tensor)."""
    if isinstance(out, torch.Tensor) and out.is_cuda:
        torch.cuda.synchronize(out.device)


def timeit(fn, *args, n: int = 20, warmup: int = 2):
    """(seconds_per_call, last_output): ``warmup`` calls, then ``n`` calls
    dispatched back to back, the clock stopped at a barrier on the last
    output."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    barrier(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    barrier(out)
    return (time.perf_counter() - t0) / n, out
