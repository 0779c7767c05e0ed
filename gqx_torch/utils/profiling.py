"""Padded torch.profiler windows on the card.

torch.profiler on the H100 drops the leading device events of a window:
mostly up to some nine, now and then about 3 ms of them
(``gqx_torch/scripts/profiler_probe.py``; PERF.md).  A window therefore
opens with ``PAD_CALLS`` launches of ATen's spin kernel, synchronised,
which the sums leave out (``is_pad``); a window that shows none of them may
have lost events of its own, and is profiled again with spins ten times
longer (``PAD_CYCLES``).  ``chip_smoke.py``'s ``device_ms``,
``gqx_torch.bench.device_split`` and the runner's ``--profile-dir`` trace
open their windows so.
"""

from __future__ import annotations

import torch

PAD_CALLS = 64
#: the spin kernel's name holds this
PAD_KEY = "spin_kernel"
#: clock cycles of one spin (about 50 us at 1.98 GHz), then of each retry's
PAD_CYCLES = (100_000, 1_000_000, 10_000_000)


def pad_window(cycles: int = PAD_CYCLES[0]) -> None:
    """``PAD_CALLS`` spin kernels of ``cycles`` clock cycles on the current
    card, then a synchronise."""
    for _ in range(PAD_CALLS):
        torch.cuda._sleep(cycles)
    torch.cuda.synchronize()


def is_pad(name: str) -> bool:
    """Whether a device event is one of ``pad_window``'s spins."""
    return PAD_KEY in name
