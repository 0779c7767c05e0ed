"""The port's own profiler ranges, and padded torch.profiler windows on the
card.

``span(name)`` is a ``record_function`` range while a torch.profiler
records, and one shared null context otherwise.  The flag it reads is the
autograd profiler's, process-wide (the autograd engine's thread sees it
too), read at each entry: an untraced step pays a flag read a span, where
a ``record_function`` range costs some 14 us on a CPU host even with no
profiler running.  Every name is a key of ``SPAN_NAMES``, with what its
range holds.  The ranges are the profiler's user annotations, in one
timeline with the device events they launch.

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

import contextlib

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.autograd.profiler import record_function

#: every span of the port, with what its range holds (device work where it
#: does not say "host")
SPAN_NAMES = {
    "gqx_torch::data.batch": "the pipeline's next global batch: index gather, augment, label "
                             "cast; closed before the batch is yielded (host)",
    "gqx_torch::data.augment": "the native or numpy augment of a global batch, inside "
                               "data.batch (host)",
    "gqx_torch::data.to_device": "runner.to_device: the pageable copy to the device and the "
                                 "NHWC -> NCHW permute",
    "gqx_torch::fwd_bwd": "the per-user gradients: the folded forward and backward, or the "
                          "per-user loop",
    "gqx_torch::bn.forward": "one batch norm's forward",
    "gqx_torch::bn.backward": "one grouped batch norm's backward (on the autograd thread)",
    "gqx_torch::fwd_bwd.per_user_dw": "one folded conv's or dense layer's per-user weight "
                                      "gradient (K7, the 1x1 einsum, the per-user library "
                                      "calls, the dense einsum) with its casts",
    "gqx_torch::aggregate": "the aggregation of every unit: pack, encode, decode, and on a "
                            "mesh the exchange",
    "gqx_torch::aggregate.pack": "the users' leaves into compression units: casts, permutes, "
                                 "cat",
    "gqx_torch::aggregate.encode": "one unit's encode with its draws; the error-feedback "
                                   "error or the ring's carry added before it",
    "gqx_torch::aggregate.decode": "one unit's decode and the users' mean; the new "
                                   "error-feedback error",
    "gqx_torch::collective.pack": "a unit's signatures packed into wire rows (mesh)",
    "gqx_torch::collective.exchange": "a collective or point-to-point exchange across ranks "
                                      "(mesh)",
    "gqx_torch::collective.unpack": "wire rows unpacked into a unit's signatures (mesh)",
    "gqx_torch::update.sgd": "the fused SGD update with momentum and weight decay",
    "gqx_torch::update.bn_stats": "the batch norms' running statistics",
}

_NULL = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``name`` (a key of ``SPAN_NAMES``) while a
    torch.profiler records, else the shared null context."""
    if _autograd_profiler._is_profiler_enabled:
        return record_function(name)
    return _NULL


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
